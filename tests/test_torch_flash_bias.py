"""The bias variant of the port's flash attention against the JAX package.

The plain ``_flash_fwd_reference`` and ``_flash_bwd_reference`` with a
per-key ``kv_bias`` (what K1-K3's bias kernels compute, and their
yardstick on the card) are held against the Pallas ``_fwd_kernel``,
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` with ``has_bias`` run in
interpret mode on the same inputs; the public
``flash_attention(..., kv_bias=)`` against ``jax.vjp`` of JAX's. Each
over causal and not, n_rep 1 and 2, f32 and bf16, one and two kv blocks,
with a padding bias (0 on real keys, -1e30 on padding) that leaves one
sequence all padding, and with a random bias N(0, 3^2).

A sequence that is all padding gives o = 0 and zero gradients, as the
Pallas kernel does (JAX's CPU fallback ``_masked_attention_xla`` would
give the mean of V instead): its lse stays near -1e30 and is compared
exactly. Tolerances: f32 2e-4, bf16 2e-2 (one bf16 rounding of p or ds
may land differently), the forward's o absolute, lse absolute on rows
with a valid key, gradients relative to each one's largest entry.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as port

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")

TOL = {"float32": 2e-4, "bfloat16": 2e-2}
T, D = 32, 16


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _bias(kind, b, t, seed=5):
    """[B, T] f32: ``padding`` with lengths (t, t - 11, 0, 7, ...) (the
    third sequence all padding), or ``random`` N(0, 3^2)."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (3.0 * rng.standard_normal((b, t))).astype(np.float32)
    lengths = [t, t - 11, 0, 7][:b]
    mask = np.arange(t)[None, :] < np.array(lengths)[:, None]
    return np.where(mask, 0.0, -1e30).astype(np.float32)


def _inputs(seed, b, h, hkv, t, d, layout="bhtd"):
    rng = np.random.default_rng(seed)
    if layout == "bhtd":
        shapes = [(b, h, t, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, t, d)]
    else:
        shapes = [(b, t, h, d), (b, t, hkv, d), (b, t, hkv, d), (b, t, h, d)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _torch(a, dtype):
    return torch.from_numpy(_np(a).copy()).to(getattr(torch, dtype))


def _rel_close(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL[dtype], f"{what}: relative error {err}"


CASES = [pytest.param(causal, n_rep, dtype, block, kind,
                      id=f"{'causal' if causal else 'bidir'}-rep{n_rep}-"
                         f"{dtype}-blk{block}-{kind}")
         for causal in (False, True) for n_rep in (1, 2)
         for dtype in ("float32", "bfloat16") for block in (32, 16)
         for kind in ("padding", "random")]


@pytest.mark.parametrize("causal,n_rep,dtype,block,kind", CASES)
def test_fwd_reference_matches_pallas_bias_kernel(causal, n_rep, dtype,
                                                  block, kind):
    """block 32 = one kv block; 16 = two, so the Pallas kernel's running
    max rescales across a padded block."""
    hkv, b = 2, 3
    q, k, v, _ = (jnp.asarray(a, dtype)
                  for a in _inputs(0, b, hkv * n_rep, hkv, T, D))
    bias = _bias(kind, b, T)
    o, lse = fa_mod._flash_fwd_impl(q, k, v, jnp.asarray(bias)[:, None, :],
                                    causal, block, block)
    o_t, lse_t = port._flash_fwd_reference(
        *(_torch(a, dtype) for a in (q, k, v)), causal,
        torch.from_numpy(bias))
    assert o_t.dtype == getattr(torch, dtype) and lse_t.dtype == torch.float32
    np.testing.assert_allclose(_np(o_t), _np(o), rtol=0, atol=TOL[dtype])
    lse_t, lse = _np(lse_t), _np(lse)
    valid = lse > -1e29
    np.testing.assert_array_equal(lse_t > -1e29, valid)
    np.testing.assert_allclose(lse_t[valid], lse[valid], rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_array_equal(lse_t[~valid], lse[~valid])
    if kind == "padding":
        # The all-padding sequence: exact zeros, as the Pallas kernel.
        assert not _np(o_t)[2].any() and not _np(o)[2].any()


@pytest.mark.parametrize("causal,n_rep,dtype,block,kind", CASES)
def test_bwd_reference_matches_pallas_bias_kernels(causal, n_rep, dtype,
                                                   block, kind):
    hkv, b = 2, 3
    q, k, v, do = (jnp.asarray(a, dtype)
                   for a in _inputs(1, b, hkv * n_rep, hkv, T, D))
    bias = jnp.asarray(_bias(kind, b, T))[:, None, :]
    o, lse = fa_mod._flash_fwd_impl(q, k, v, bias, causal, block, block)
    want = fa_mod._flash_bwd_impl(q, k, v, bias, o, lse, do, causal, block,
                                  block)
    dq, dk_h, dv_h = port._flash_bwd_reference(
        *(_torch(a, dtype) for a in (q, k, v, o)),
        torch.from_numpy(np.array(lse)), _torch(do, dtype), causal,
        torch.from_numpy(np.array(bias[:, 0])))
    got = (dq,) + port._sum_kv_heads(dk_h, dv_h, hkv)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == getattr(torch, dtype), name
        _rel_close(g, w, dtype, name)
        if kind == "padding":
            assert not _np(g)[2].any() and not _np(w)[2].any(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("kind", ["padding", "random"])
def test_public_flash_attention_with_bias_matches_jax_vjp(kind, causal,
                                                          dtype):
    """T = 37, GQA n_rep 2: the port's autograd through the op against
    ``jax.vjp`` of the JAX public function; the bias gets no gradient in
    either (JAX's cotangent is zeros, the port's bias stays unreached)."""
    b, t = 3, 37
    q, k, v, w = _inputs(2, b, 4, 2, t, D, layout="bthd")
    bias = _bias(kind, b, t, seed=6)

    def jf(q, k, v, bias):
        out = fa_mod.flash_attention(q, k, v, causal=causal, kv_bias=bias)
        return out.astype(jnp.float32)

    out, vjp = jax.vjp(jf, *(jnp.asarray(a, dtype) for a in (q, k, v)),
                       jnp.asarray(bias))
    want = vjp(jnp.asarray(w))
    tq, tk, tv = (_torch(a, dtype).requires_grad_(True) for a in (q, k, v))
    tbias = torch.from_numpy(bias).requires_grad_(True)
    got = port.flash_attention(tq, tk, tv, causal=causal, kv_bias=tbias)
    np.testing.assert_allclose(_np(got), _np(out), rtol=0, atol=TOL[dtype])
    (got.float() * torch.from_numpy(w)).sum().backward()
    for name, g, ww in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                           want):
        _rel_close(g, ww, dtype, name)
    assert tbias.grad is None
    assert not np.asarray(want[3]).any()


def test_op_saves_the_bias_and_gives_it_no_cotangent():
    """The custom op takes the bias as an input it saves with its
    residuals; its backward runs the bias backward (the same gradients
    as the plain bias backward) and returns None for the bias."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(3, 2, 2, 1, 9, D))
    bias = torch.from_numpy(_bias("random", 2, 9))
    qg, kg, vg = (x.clone().requires_grad_(True) for x in (q, k, v))
    o, lse = port.flash_fwd(qg, kg, vg, False, bias)
    assert not lse.requires_grad
    dq, dk, dv = torch.autograd.grad(o, (qg, kg, vg), do)
    o_ref, lse_ref = port._flash_fwd_reference(q, k, v, False, bias)
    torch.testing.assert_close(o.detach(), o_ref, rtol=0, atol=0)
    want = port._flash_bwd_reference(q, k, v, o_ref, lse_ref, do, False,
                                     bias)
    want = (want[0],) + port._sum_kv_heads(want[1], want[2], 1)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    # Without the bias the op is the plain one.
    o_plain, _ = port.flash_fwd(q, k, v, False)
    assert not torch.equal(o_plain, o.detach())


def test_zero_bias_is_the_plain_function():
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 2, 4, 2, 11, D))
    zero = torch.zeros(2, 11)
    for causal in (False, True):
        o0, lse0 = port._flash_fwd_reference(q, k, v, causal)
        o1, lse1 = port._flash_fwd_reference(q, k, v, causal, zero)
        assert torch.equal(o0, o1) and torch.equal(lse0, lse1)
        g0 = port._flash_bwd_reference(q, k, v, o0, lse0, do, causal)
        g1 = port._flash_bwd_reference(q, k, v, o0, lse0, do, causal, zero)
        assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_bias_on_a_masked_key_stays_below_the_guard():
    """-1e30 of padding on top of the causal -1e30 gives -2e30, which the
    guard (s > -1e30/2) still drops: no clamp, as in JAX."""
    s = port._add_bias(port._causal_mask(torch.zeros(1, 1, 2, 2), True),
                       torch.tensor([[0.0, -1e30]]))
    assert s[0, 0, 0, 1] == -2e30 and s[0, 0, 1, 1] == -1e30
