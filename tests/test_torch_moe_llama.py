"""The port's sparse-MoE Llama against the JAX package on the CPU.

On ``tiny_moe`` at f32, from one JAX-initialised tree (moved bit for bit
by ``from_jax_params``) and numpy-made batches, with the JAX flash
kernels in Pallas interpret mode and JAX's ``_grouped_mm`` on its
one-hot fallback: ``llama_loss`` and every gradient leaf under each
remat mode, with the grouped-matmul (K5) count that shows what the
backward recomputed; ``llama_forward``'s aux loss; the decode FFN's two
paths; ``llama_generate`` and ``DecodeEngine`` token for token; the split
train step after 3 steps; the init tree and its conversion; and the
configs that must raise.

Routing is checked first: every test that routes asserts that the
smallest gap between the K-th and (K+1)-th router probability is far
above f32 noise, so no expert can flip between the frameworks.

Tolerances: f32 loss 1e-6 relative and gradients 2e-5 relative to each
leaf's largest entry (the same f32 arithmetic summed in another order);
remat modes against ``none`` 1e-6; split-step losses 1e-5 and params
1e-4 absolute at learning rate 1e-3 (test_torch_train_step.py states
why); decode FFN 1e-5.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import generate as jg
from horovod_tpu.models import llama as jl
from horovod_tpu.parallel import fused_adam as j_fused_adam
from horovod_tpu.parallel import make_split_train_step as j_make_step
from horovod_tpu_torch.models import generate as tg
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import from_jax_params
from horovod_tpu_torch.ops import grouped_moe as gm
from horovod_tpu_torch.parallel import precision
from horovod_tpu_torch.parallel.train_step import make_split_train_step
from horovod_tpu_torch.serving.engine import DecodeEngine
from horovod_tpu_torch.serving.scheduler import poisson_trace

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")
MARGIN = 1e-5       # far above the ~1e-7 f32 noise of a router probability
LR = 1e-3


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


def _batch(seed, vocab, b=2, t=16):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    return {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}


def _port(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), device="cpu")


@pytest.fixture(scope="module")
def moe():
    jc = jl.LlamaConfig.tiny_moe(dtype="float32", remat=False)
    tc = tl.LlamaConfig.tiny_moe(dtype="float32", remat="none")
    return jc, tc, jl.llama_init(jc, jax.random.PRNGKey(0))


@pytest.fixture
def margins(monkeypatch):
    """Record the top-K probability gap of every routing call the port
    makes (training dispatch and decode alike)."""
    seen = []
    plain = tl.moe_route

    def recording(h, router_w, k):
        probs = torch.softmax(h.detach().float() @ router_w.detach().float(),
                              -1)
        top = probs.sort(-1, descending=True).values
        seen.append(float((top[..., k - 1] - top[..., k]).min()))
        return plain(h, router_w, k)

    monkeypatch.setattr(tl, "moe_route", recording)
    monkeypatch.setattr(tg, "moe_route", recording)
    return seen


def _count_k5(monkeypatch):
    """Count forward grouped products through the plain K5 (the dlhs
    plain version reaches it transposed, and is not counted)."""
    calls = []
    plain = gm._gmm_reference

    def counted(*args, transpose_rhs=False, **kw):
        if not transpose_rhs:
            calls.append(1)
        return plain(*args, transpose_rhs=transpose_rhs, **kw)

    monkeypatch.setattr(gm, "_gmm_reference", counted)
    return calls


def _port_value_and_grad(params, batch, cfg):
    leaves = _flat(params)
    for v in leaves.values():
        v.requires_grad_(True)
    loss = tl.llama_loss(params, batch, cfg, device="cpu")
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


@pytest.fixture(scope="module")
def jax_reference(moe):
    jc, _, jparams = moe
    batch = _batch(1, jc.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(jl.llama_loss)(jparams, jb, jc)
    return batch, float(loss), {k: np.asarray(v)
                                for k, v in _flat(grads).items()}


def _assert_grads_close(got, want, tol):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = _np(got[k])
        assert g.shape == w.shape, k
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, f"{k}: relative error {err}"


@pytest.mark.parametrize("mode,k5_per_layer", [
    ("none", 3), ("full", 6), ("attn", 6), ("attn+gate", 6),
    ("attn+moe", 5), ("moe", 3)])
def test_moe_loss_and_grads_match_jax_per_remat_mode(
        moe, jax_reference, margins, monkeypatch, mode, k5_per_layer):
    """Every mode gives JAX's loss and gradients; the grouped products
    re-run as the save-set says (3 per layer in the forward)."""
    _, tc, jparams = moe
    batch, want_loss, want_grads = jax_reference
    calls = _count_k5(monkeypatch)
    loss, grads = _port_value_and_grad(
        _port(jparams), batch, dataclasses.replace(tc, remat=mode))
    assert min(margins) > MARGIN
    assert len(calls) == k5_per_layer * tc.n_layers
    assert float(loss) == pytest.approx(want_loss, rel=1e-6)
    _assert_grads_close(grads, want_grads, 2e-5)


def test_moe_remat_modes_give_none_gradients(moe):
    _, tc, jparams = moe
    batch = _batch(2, tc.vocab_size)
    ref_loss, ref = _port_value_and_grad(_port(jparams), batch, tc)
    for mode in ("full", "attn", "attn+moe", "moe"):
        loss, grads = _port_value_and_grad(
            _port(jparams), batch, dataclasses.replace(tc, remat=mode))
        assert float(loss) == float(ref_loss), mode
        _assert_grads_close(grads, {k: _np(v) for k, v in ref.items()},
                            1e-6)


def test_moe_forward_logits_and_aux_match_jax(moe, margins):
    jc, tc, jparams = moe
    tokens = _batch(3, jc.vocab_size)["tokens"]
    want, want_aux = jl.llama_forward(jparams, jnp.asarray(tokens), jc,
                                      return_aux=True)
    logits, aux = tl.llama_forward(_port(jparams), tokens, tc,
                                   return_aux=True, device="cpu")
    assert min(margins) > MARGIN
    np.testing.assert_allclose(_np(logits), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(aux) > 0.0
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


@pytest.mark.parametrize("b", [1, 2])
def test_decode_ffn_paths_match_jax(moe, margins, monkeypatch, b):
    """B*T*K < E (b=1 at E4 K2) takes the top-K gather, which runs no
    grouped product; b=2 takes the grouped dispatch (3 products)."""
    jc, tc, jparams = moe
    lp = {k: v[0] for k, v in _port(jparams)["layers"].items()}
    jlp = jax.tree.map(lambda w: w[0], jparams["layers"])
    h = np.random.default_rng(4).standard_normal((b, 1, 64)).astype(
        np.float32)
    calls = _count_k5(monkeypatch)
    out = tg._decode_ffn(torch.from_numpy(h), lp, tc)
    want = jg._decode_ffn(jnp.asarray(h), jlp, jc)
    assert min(margins) > MARGIN
    assert len(calls) == (0 if b == 1 else 3)
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_topk_and_grouped_decode_ffn_agree(moe):
    """Both decode paths compute the same FFN on one token."""
    _, tc, jparams = moe
    lp = {k: v[1] for k, v in _port(jparams)["layers"].items()}
    h = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 1, 64)).astype(np.float32))
    torch.testing.assert_close(tg._moe_ffn_topk(h, lp, tc),
                               tg._ffn(h, lp, tc), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def moe_serving():
    jc = jl.LlamaConfig.tiny_moe(dtype="float32", n_layers=2)
    tc = tl.LlamaConfig.tiny_moe(dtype="float32", n_layers=2)
    jp = jl.llama_init(jc, jax.random.PRNGKey(0))
    return jc, jp, tc, _port(jp)


@pytest.mark.parametrize("b,t,new", [(2, 6, 5), (1, 9, 6)])
def test_moe_greedy_generate_token_identical_f32(moe_serving, margins, b,
                                                 t, new):
    """Mirrors tests/single/test_generate.py's MoE greedy decode: b=2
    decodes through the grouped dispatch, b=1 through the top-K
    gather."""
    jc, jp, tc, tp = moe_serving
    prompt = np.random.default_rng(6 + b).integers(0, 256, (b, t)).astype(
        np.int32)
    ref = np.asarray(jg.llama_generate(jp, jnp.asarray(prompt), jc, new))
    out = tg.llama_generate(tp, prompt, tc, new, device="cpu")
    assert min(margins) > MARGIN
    np.testing.assert_array_equal(out.numpy(), ref)


def test_moe_engine_matches_jax_generate_mid_flight(moe_serving, margins):
    jc, jp, tc, tp = moe_serving
    eng = DecodeEngine(tp, tc, block_size=4, n_blocks=64, max_batch=3,
                       max_context=24, device="cpu")
    trace = poisson_trace(5, 1000.0, seed=7, prompt_len=(3, 9),
                          max_new=(2, 6), vocab_size=256)
    for r in trace[:2]:
        eng.submit(r)
    eng.step()
    for r in trace[2:]:
        eng.submit(r)
    done = eng.run_until_idle()
    assert min(margins) > MARGIN
    for r in trace:
        ref = np.asarray(jg.llama_generate(
            jp, jnp.asarray(r.prompt)[None, :], jc, r.max_new_tokens))[0]
        np.testing.assert_array_equal(done[r.rid], ref)


def test_moe_split_step_matches_jax_after_3_steps(moe, margins):
    jc, tc, jparams = moe
    batch = _batch(8, jc.vocab_size, b=4)
    jts = j_make_step(lambda p, d: jl.llama_loss(p, d, jc),
                      j_fused_adam(LR), microbatches=2)
    # The JAX step donates its carry: hand it a copy of the shared tree.
    jcarry = jts.init(jax.tree.map(jnp.copy, jparams))
    ts = make_split_train_step(
        lambda p, d: tl.llama_loss(p, d, dataclasses.replace(
            tc, remat="moe"), device="cpu"),
        precision.fused_adam(LR), microbatches=2)
    carry = ts.init(_port(jparams))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jloss, jcarry = jts.step(jcarry, jb)
        loss, carry = ts.step(carry, tb)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    assert min(margins) > MARGIN
    got, want = _flat(carry[0]), _flat(jcarry[0])
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(_np(got[k]), np.asarray(w), rtol=0,
                                   atol=1e-4, err_msg=k)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_moe_init_tree_matches_jax(param_dtype):
    jc = jl.LlamaConfig.tiny_moe(param_dtype=param_dtype)
    tc = tl.LlamaConfig.tiny_moe(param_dtype=param_dtype)
    jp = _flat(jl.llama_init(jc, jax.random.PRNGKey(0)))
    tp = _flat(tl.llama_init(tc, torch.Generator().manual_seed(0),
                             device="cpu"))
    assert sorted(jp) == sorted(tp)
    assert "layers/w_gate" not in tp and "layers/moe_down" in tp
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert tp[k].dtype == getattr(torch, param_dtype), k
    for k in ("layers/router", "layers/moe_gate", "layers/moe_down"):
        assert np.std(_np(tp[k])) == pytest.approx(
            np.std(_np(jp[k])), rel=0.1), k


def test_moe_tree_round_trips_from_jax():
    jp = jl.llama_init(jl.LlamaConfig.tiny_moe(param_dtype="bfloat16"),
                       jax.random.PRNGKey(3))
    tp = _flat(_port(jp))
    for k, a in _flat(jp).items():
        a = np.asarray(a)
        assert tp[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            tp[k].view(torch.int16).numpy().view(np.uint16),
            a.view(np.uint16), k)


def test_gshard_dispatch_raises_naming_a8(moe):
    _, tc, jparams = moe
    cfg = dataclasses.replace(tc, moe_impl="gshard")
    with pytest.raises(NotImplementedError, match="A8"):
        tl.llama_loss(_port(jparams), _batch(0, 256), cfg, device="cpu")


def test_unknown_moe_impl_raises(moe):
    _, tc, jparams = moe
    with pytest.raises(ValueError, match="unknown moe_impl"):
        tl.llama_loss(_port(jparams), _batch(0, 256),
                      dataclasses.replace(tc, moe_impl="sparse"),
                      device="cpu")


@pytest.mark.parametrize("mode", ["attn+moe", "moe"])
@pytest.mark.parametrize("cfg", ["dense", "gshard"])
def test_moe_remat_modes_need_the_grouped_dispatch(mode, cfg):
    c = tl.LlamaConfig.tiny(remat=mode) if cfg == "dense" else \
        tl.LlamaConfig.tiny_moe(remat=mode, moe_impl="gshard")
    with pytest.raises(ValueError, match="grouped MoE dispatch"):
        tl._build_layer_body(c)
