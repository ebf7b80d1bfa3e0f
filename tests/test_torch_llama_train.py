"""The port's training forward against the JAX package.

``llama_loss`` and every gradient leaf against
``jax.value_and_grad(llama_loss)`` on one JAX-initialised tree (moved
bit for bit by ``from_jax_params``) and numpy-made batches, with the
JAX flash kernels in Pallas interpret mode; every remat mode against
``none`` (the A1 modes also against JAX's same mode), with the
flash-forward (K1) count
that shows what the backward recomputed, and the three modes of A1 on
the grouped MoE with their grouped-matmul (K5) count; and the mode that
must raise. The counts are the TPU program's: under ``dots`` K1 is
recomputed (a ``pallas_call`` there, not a dot), though JAX's CPU run
saves its einsum attention. The MoE model's training:
test_torch_moe_llama.py.

Tolerances: f32 loss 1e-6 relative, f32 gradients 2e-5 relative to
each leaf's largest entry (the same f32 arithmetic summed in another
order); bf16 loss 1e-3 and gradients 5e-2 relative (bf16 activations
round at places the two frameworks order differently, and the rounding
differences propagate through the layers and their backward).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import from_jax_params
from horovod_tpu_torch.ops import flash_attention as port_fa

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _batch(seed, vocab, b=2, t=16, mask=False):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}
    if mask:
        batch["mask"] = (rng.random((b, t)) > 0.3).astype(np.float32)
    return batch


def _port_value_and_grad(params, batch, cfg):
    leaves = _flat(params)
    for v in leaves.values():
        v.requires_grad_(True)
    loss = tl.llama_loss(params, batch, cfg, device="cpu")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def _jax_value_and_grad(jparams, batch, cfg):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jl.llama_loss)(jparams, jb, cfg)
    return float(loss), {k: np.asarray(v) for k, v in _flat(grads).items()}


def _setup(dtype="float32", param_dtype="float32", seed=0, **kw):
    jc = jl.LlamaConfig.tiny(dtype=dtype, param_dtype=param_dtype,
                             remat=False, **kw)
    tc = tl.LlamaConfig.tiny(dtype=dtype, param_dtype=param_dtype,
                             remat="none", **kw)
    jparams = jl.llama_init(jc, jax.random.PRNGKey(seed))
    return jc, tc, jparams


def _params(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")


def _assert_grads_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = _np(got[k])
        assert g.shape == w.shape, k
        err = np.abs(g - np.asarray(w, np.float32)).max() / max(
            np.abs(np.asarray(w, np.float32)).max(), 1e-30)
        assert err <= tol, f"{k}: relative error {err}"


@pytest.mark.parametrize("mask", [False, True])
def test_llama_loss_and_grads_match_jax(mask):
    jc, tc, jparams = _setup()
    batch = _batch(1, jc.vocab_size, mask=mask)
    want_loss, want_grads = _jax_value_and_grad(jparams, batch, jc)
    loss, grads = _port_value_and_grad(_params(jparams), batch, tc)
    assert loss.dtype == torch.float32
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    _assert_grads_close(grads, want_grads, 2e-5)


def test_bf16_params_loss_and_grads_match_jax():
    jc, tc, jparams = _setup(dtype="bfloat16", param_dtype="bfloat16")
    batch = _batch(2, jc.vocab_size)
    want_loss, want_grads = _jax_value_and_grad(jparams, batch, jc)
    loss, grads = _port_value_and_grad(_params(jparams), batch, tc)
    assert all(g.dtype == torch.bfloat16 for g in grads.values())
    assert float(loss) == pytest.approx(want_loss, rel=1e-3)
    _assert_grads_close(grads, want_grads, 5e-2)


def test_llama_forward_logits_match_jax():
    jc, tc, jparams = _setup()
    tokens = _batch(3, jc.vocab_size)["tokens"]
    want, want_aux = jl.llama_forward(jparams, jnp.asarray(tokens), jc,
                                      return_aux=True)
    logits, aux = tl.llama_forward(_params(jparams), tokens, tc,
                                   return_aux=True, device="cpu")
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(want_aux) == 0.0


A1_MODES = ("dots", "attn+ffn", "attn+gate+qkv")


def _count(monkeypatch, module, name, keep=lambda **kw: True):
    """Count the calls of ``module.name`` (a plain kernel version) whose
    keywords ``keep`` accepts."""
    calls = []
    plain = getattr(module, name)

    def counted(*args, **kw):
        if keep(**kw):
            calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("mode,k1_calls", [
    ("none", 2), ("full", 4), ("attn", 2), ("attn+gate", 2), ("dots", 4),
    ("attn+ffn", 2), ("attn+gate+qkv", 2)])
def test_remat_modes_agree_and_count_flash_forwards(mode, k1_calls,
                                                    monkeypatch):
    """Every mode gives the 'none' gradients (held to JAX's by
    test_llama_loss_and_grads_match_jax), the A1 modes also JAX's under
    the same mode; the flash forward runs once per layer per grad call,
    twice under full remat and under dots (2 layers)."""
    jc, tc, jparams = _setup()
    batch = _batch(4, tc.vocab_size)
    ref_loss, ref_grads = _port_value_and_grad(_params(jparams), batch, tc)
    calls = _count(monkeypatch, port_fa, "_flash_fwd_reference")
    cfg = dataclasses.replace(tc, remat=mode)
    loss, grads = _port_value_and_grad(_params(jparams), batch, cfg)
    assert len(calls) == k1_calls
    assert float(loss) == float(ref_loss)
    _assert_grads_close(grads, {k: _np(v) for k, v in ref_grads.items()},
                        1e-6)
    if mode in A1_MODES:
        want_loss, want_grads = _jax_value_and_grad(
            jparams, batch, dataclasses.replace(jc, remat=mode))
        assert float(loss) == pytest.approx(want_loss, rel=1e-6)
        _assert_grads_close(grads, want_grads, 2e-5)


@pytest.mark.parametrize("mode,k1_calls,k5_calls", [
    ("dots", 4, 12), ("attn+ffn", 2, 12), ("attn+gate+qkv", 2, 12)])
def test_a1_remat_modes_on_the_grouped_moe(mode, k1_calls, k5_calls,
                                           monkeypatch):
    """The three A1 modes on ``tiny_moe`` (the dropless grouped dispatch,
    2 layers): JAX's loss and gradients under the same mode, and the
    TPU program's recompute, K5 3 a layer in the forward and all three
    again in the backward (the router's combine gradient needs
    ``y_slots``, which none of them saves)."""
    from horovod_tpu_torch.ops import grouped_moe as gm

    jc = jl.LlamaConfig.tiny_moe(dtype="float32", remat=mode)
    tc = tl.LlamaConfig.tiny_moe(dtype="float32", remat=mode)
    jparams = jl.llama_init(jc, jax.random.PRNGKey(0))
    batch = _batch(1, jc.vocab_size)
    want_loss, want_grads = _jax_value_and_grad(jparams, batch, jc)
    k1 = _count(monkeypatch, port_fa, "_flash_fwd_reference")
    k5 = _count(monkeypatch, gm, "_gmm_reference",
                lambda transpose_rhs=False, **kw: not transpose_rhs)
    loss, grads = _port_value_and_grad(_params(jparams), batch, tc)
    assert (len(k1), len(k5)) == (k1_calls, k5_calls)
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    _assert_grads_close(grads, want_grads, 2e-5)


def test_lm_head_logits_keep_f32_products():
    """bf16 operands, f32 result with no bf16 rounding: equal to the
    f32 product of the upcast operands, unlike (h @ w).float()."""
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((2, 3, 64)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((64, 256)).astype(
        np.float32)).bfloat16()
    out = tl._F32Logits.apply(h, w)
    want = h.float() @ w.float()
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
    assert (out - (h @ w).float()).abs().max() > 0


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="unknown remat"):
        tl._build_layer_body(tl.LlamaConfig.tiny(remat="most"))
