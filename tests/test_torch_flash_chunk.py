"""The offsets variant of the port's flash attention (one ring step)
against the JAX package.

The port's ``flash_attention_chunk`` (the op ``hvd_torch::flash_chunk``;
on CPU tensors its plain ``_flash_fwd_reference`` and
``_flash_bwd_reference`` with ``offsets``, what K1-K3's offsets kernels
compute and their yardstick on the card) is held against JAX's
``flash_attention_chunk``: the Pallas ``_fwd_kernel``,
``_bwd_dkv_kernel`` and ``_bwd_dq_kernel`` with ``has_offsets`` run in
interpret mode. Values, and the gradients under a random lse cotangent
(``jax.vjp`` against ``torch.autograd.grad`` with the same cotangents),
over causal and not, n_rep 1 and 2, ``Tq != Tk``, and the chunks a ring
meets: past, diagonal, wholly future, and misaligned (the kv chunk
starting inside a q block, so rows with no valid key sit inside a
block that is not skipped).

Tolerances (f32): o 1e-5 absolute; lse 1e-5 absolute on rows with a
valid key, and at or below -1e29 and finite on both sides on rows
without one; dq, dk and dv 1e-4 of each tensor's largest entry.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as port

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")

D = 8


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _inputs(seed, b, h, hkv, tq, tk):
    """q, k, v, do in the kernel layout and a random lse cotangent."""
    rng = np.random.default_rng(seed)
    shapes = [(b, h, tq, D), (b, hkv, tk, D), (b, hkv, tk, D),
              (b, h, tq, D), (b, h, tq, 1)]
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _rel_close(got, want, tol, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: relative error {err}"


def _lse_close(got, want):
    """lse: 1e-5 on rows with a valid key; rows without one at or below
    -1e29 and finite in both packages."""
    got, want = _np(got), _np(want)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    valid = want > -1e29
    np.testing.assert_array_equal(got > -1e29, valid)
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)
    assert (got[~valid] <= -1e29).all()


# (name, Tq, Tk, q_offset, kv_offset): the chunks one rank's ring meets.
CHUNKS = [("past", 32, 32, 64, 0), ("diagonal", 32, 32, 32, 32),
          ("future", 32, 32, 0, 64), ("misaligned", 32, 32, 16, 24),
          ("tq_ne_tk", 32, 16, 32, 40), ("tq_ne_tk_past", 16, 32, 48, 0)]
CASES = [pytest.param(causal, n_rep, *chunk,
                      id=f"{'causal' if causal else 'bidir'}-rep{n_rep}-"
                         f"{chunk[0]}")
         for causal in (True, False) for n_rep in (1, 2) for chunk in CHUNKS
         if causal or chunk[0] in ("diagonal", "tq_ne_tk")]


def _jax_chunk(q, k, v, q_offset, kv_offset, causal):
    return fa_mod.flash_attention_chunk(q, k, v, q_offset, kv_offset,
                                        causal=causal, block_q=16,
                                        block_k=16)


@pytest.mark.parametrize("causal,n_rep,name,tq,tk,q_offset,kv_offset",
                         CASES)
def test_chunk_matches_pallas_offsets_kernels(causal, n_rep, name, tq, tk,
                                              q_offset, kv_offset):
    """Values and gradients (with a random dlse) of one chunk, 16-row
    Pallas blocks: two q and kv blocks, so the offsets cut blocks."""
    hkv, b = 2, 2
    q, k, v, do, dlse = _inputs(3, b, hkv * n_rep, hkv, tq, tk)
    (o, lse), vjp = jax.vjp(
        lambda *a: _jax_chunk(*a, q_offset, kv_offset, causal),
        *(jnp.asarray(a) for a in (q, k, v)))
    want = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o_t, lse_t = port.flash_attention_chunk(qt, kt, vt, q_offset, kv_offset,
                                            causal)
    got = torch.autograd.grad((o_t, lse_t), (qt, kt, vt),
                              (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(_np(o_t), _np(o), rtol=0, atol=1e-5)
    _lse_close(lse_t, lse)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        _rel_close(g, w, 1e-4, f"{name} {what}")
    if name == "future":
        # No key visible: o and every gradient exactly 0 in both.
        assert not _np(o_t).any() and not _np(o).any()
        for g, w in zip(got, want):
            assert not _np(g).any() and not _np(w).any()


def test_zero_valid_rows_inside_a_relevant_block():
    """JAX's test_zero_valid_key_rows_zero_output_and_grads: one 16-row
    block, the kv chunk starting at global 8, so rows 0-7 see no key
    inside a block the causal skip does not drop. Their o is exactly 0
    and their lse at or below -1e29 in both packages, and a cotangent
    only on those rows gives exactly zero gradients."""
    q, k, v, _, _ = _inputs(7, 1, 2, 2, 16, 16)
    o, lse = fa_mod.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0, 8, causal=True,
        block_q=16, block_k=16)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o_t, lse_t = port.flash_attention_chunk(qt, kt, vt, 0, 8)
    np.testing.assert_allclose(_np(o_t), _np(o), rtol=0, atol=1e-5)
    _lse_close(lse_t, lse)
    assert not _np(o_t)[:, :, :8].any()
    assert (np.abs(_np(o_t)[:, :, 8:]) > 0).all()
    loss = (o_t[:, :, :8] ** 2).sum() + o_t[:, :, :8].sum()
    for g in torch.autograd.grad(loss, (qt, kt, vt)):
        assert not _np(g).any()


@pytest.mark.parametrize("causal", [False, True])
def test_two_chunk_merge_equals_full_attention(causal):
    """JAX's test_chunked_offsets_kernel_matches_reference: two kv chunks
    merged by logsumexp equal one full-width attention, values and
    gradients (through both chunks' o and lse)."""
    q, k, v, do, _ = _inputs(5, 1, 4, 2, 32, 32)

    def merged(qq, kk, vv):
        o, lse = zip(*(port.flash_attention_chunk(
            qq, kk[:, :, j:j + 16], vv[:, :, j:j + 16], 0, j, causal)
            for j in (0, 16)))
        new = torch.logaddexp(lse[0], lse[1])
        return (torch.exp(lse[0] - new) * o[0]
                + torch.exp(lse[1] - new) * o[1])

    def full(qq, kk, vv):
        return port.flash_fwd(qq, kk, vv, causal)[0]

    grads = []
    for fn in (merged, full):
        args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = fn(*args)
        grads.append((out,) + torch.autograd.grad(out, args,
                                                  torch.from_numpy(do)))
    for g, w, what in zip(*grads, ("o", "dq", "dk", "dv")):
        _rel_close(g, w, 1e-5, what)


def test_absent_lse_cotangent_is_zero():
    """Differentiating through o alone (no lse cotangent) equals passing
    dlse = 0, and equals the ring-free op's gradients at offsets
    (0, 0)."""
    q, k, v, do, _ = _inputs(11, 1, 4, 2, 32, 32)

    def grads(dlse, op="chunk"):
        args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        if op == "chunk":
            o, lse = port.flash_attention_chunk(*args, 0, 0)
        else:
            o, lse = port.flash_fwd(*args, True)
        outs, cts = (o,), (torch.from_numpy(do),)
        if dlse is not None:
            outs, cts = (o, lse), cts + (dlse,)
        return torch.autograd.grad(outs, args, cts)

    none = grads(None)
    for other in (grads(torch.zeros(1, 4, 32, 1)), grads(None, "plain")):
        for a, b in zip(none, other):
            assert torch.equal(a, b)


def test_chunk_op_keeps_both_outputs_differentiable():
    """``hvd_torch::flash_chunk`` returns a differentiable lse, where
    ``hvd_torch::flash_fwd`` keeps its lse a residual."""
    q, k, v, _, _ = _inputs(2, 1, 2, 2, 16, 16)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    _, lse = port.flash_attention_chunk(*args, 16, 0)
    assert lse.requires_grad and lse.shape == (1, 2, 16, 1)
    _, lse_plain = port.flash_fwd(*args, True)
    assert not lse_plain.requires_grad
