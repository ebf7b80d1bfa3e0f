"""The port's BERT encoder against the JAX package.

Tiny f32 config, weights made by JAX's ``bert_init`` and carried over by
``from_jax_params``; JAX's flash kernels run in Pallas interpret mode
(``_INTERPRET``), so its attention is the Pallas bias kernel, as the
port's plain path is that kernel's function: the model-level oracle
includes a sequence that is all padding (o = 0 in both). Checked:
``bert_forward`` logits and ``bert_mlm_loss`` with every gradient, with
and without remat, and the flash forward's count per grad call (one per
layer, two under remat); three steps of ``make_split_train_step`` with
``fused_adam`` against JAX's ``make_split_train_step`` with its
``fused_adam``; the JAX model tests (``tests/single/test_resnet_bert.py``)
mirrored on the port; init and conversion.

Tolerances: logits and loss 1e-5 relative (f32, the same products summed
in another order); gradients 1e-5 relative to each leaf's largest entry;
params after Adam steps 1e-4 absolute at learning rate 1e-3 (as in
``test_torch_train_step.py``: an f32 summation-order difference in a
gradient entry near zero can move that entry by up to lr).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import bert as jb
from horovod_tpu.parallel import fused_adam as j_fused_adam
from horovod_tpu.parallel import make_split_train_step as j_make_step
from horovod_tpu_torch.models import bert as tb
from horovod_tpu_torch.models.convert import from_jax_params
from horovod_tpu_torch.ops import flash_attention as port_fa
from horovod_tpu_torch.parallel import precision
from horovod_tpu_torch.parallel._tree import tree_leaves
from horovod_tpu_torch.parallel.train_step import (
    _value_and_grad,
    make_split_train_step,
)

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")
LR = 1e-3


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _configs(remat=True):
    return (jb.BertConfig.tiny(dtype="float32", remat=remat),
            tb.BertConfig.tiny(dtype="float32", remat=remat))


def _port(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), device="cpu")


def _batch(seed, vocab, b=4, t=16):
    """Ragged lengths (t, 9, 1, 0: the last sequence all padding), ~30%
    of the real tokens predicted."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (b, t)).astype(np.int32)
    lengths = np.array([t, 9, 1, 0][:b])
    mask = (np.arange(t)[None, :] < lengths[:, None]).astype(np.int32)
    mlm = ((rng.random((b, t)) < 0.3) * mask).astype(np.float32)
    mlm[0, 0] = 1.0
    return {"tokens": tokens,
            "targets": rng.integers(0, vocab, (b, t)).astype(np.int32),
            "mlm_mask": mlm, "attention_mask": mask}


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_bert_init_matches_jax_keys_shapes_and_dtypes():
    jc, tc = _configs()
    jparams = jb.bert_init(jc, jax.random.PRNGKey(0))
    tparams = tb.bert_init(tc, torch.Generator().manual_seed(0),
                           device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    tflat = tree_leaves(tparams)
    assert len(jflat) == len(tflat)
    for (path, w), t in zip(jflat, tflat):
        assert tuple(t.shape) == w.shape, path
        assert t.dtype == torch.float32, path
    assert set(tparams) == set(jparams)
    assert set(tparams["layers"]) == set(jparams["layers"])


def test_from_jax_params_carries_a_bert_tree_across():
    jc, _ = _configs()
    jparams = jb.bert_init(jc, jax.random.PRNGKey(1))
    tparams = _port(jparams)
    for w, t in zip(jax.tree.leaves(jparams), tree_leaves(tparams)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))


@pytest.mark.parametrize("remat", [False, True])
def test_forward_logits_match_jax(remat):
    jc, tc = _configs(remat)
    jparams = jb.bert_init(jc, jax.random.PRNGKey(0))
    batch = _batch(0, jc.vocab_size)
    want = jb.bert_forward(jparams, jnp.asarray(batch["tokens"]), jc,
                           attention_mask=jnp.asarray(
                               batch["attention_mask"]))
    got = tb.bert_forward(_port(jparams), batch["tokens"], tc,
                          attention_mask=batch["attention_mask"],
                          device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == (4, 16, jc.vocab_size)
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("remat,k1_calls", [(False, 2), (True, 4)])
def test_mlm_loss_and_grads_match_jax(remat, k1_calls, monkeypatch):
    """Every gradient leaf against ``jax.value_and_grad``; the flash
    forward runs once per layer per grad call, twice under remat (the
    backward re-runs each layer), always with the bias."""
    jc, tc = _configs(remat)
    jparams = jb.bert_init(jc, jax.random.PRNGKey(0))
    batch = _batch(1, jc.vocab_size)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jb.bert_mlm_loss(p, _jax_batch(batch), jc))(jparams)
    calls = []
    plain = port_fa._flash_fwd_reference

    def counted(q, k, v, causal, kv_bias=None, offsets=None):
        calls.append((causal, kv_bias is not None))
        return plain(q, k, v, causal, kv_bias, offsets)

    monkeypatch.setattr(port_fa, "_flash_fwd_reference", counted)
    loss, grads = _value_and_grad(
        lambda p, d: tb.bert_mlm_loss(p, d, tc, device="cpu"),
        _port(jparams), _port_batch(batch), 1)
    assert calls == [(False, True)] * k1_calls
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-5)
    jleaves = jax.tree_util.tree_flatten_with_path(want_grads)[0]
    for (path, w), g in zip(jleaves, tree_leaves(grads)):
        assert np.isfinite(_np(g)).all(), path
        assert _rel(g, w) <= 1e-5, (path, _rel(g, w))


def test_split_step_fused_adam_matches_jax():
    jc, tc = _configs(remat=False)
    tc = dataclasses.replace(tc, remat=True)
    jparams = jb.bert_init(jc, jax.random.PRNGKey(2))
    batch = _batch(2, jc.vocab_size)
    jts = j_make_step(lambda p, d: jb.bert_mlm_loss(p, d, jc),
                      j_fused_adam(LR))
    jcarry = jts.init(jparams)
    ts = make_split_train_step(
        lambda p, d: tb.bert_mlm_loss(p, d, tc, device="cpu"),
        precision.fused_adam(LR))
    carry = ts.init(_port(jparams))
    jb_, tb_ = _jax_batch(batch), _port_batch(batch)
    losses = []
    for _ in range(3):
        jloss, jcarry = jts.step(jcarry, jb_)
        loss, carry = ts.step(carry, tb_)
        assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
        losses.append(float(loss))
    assert losses[-1] < losses[0]
    assert int(carry[1].count) == 3
    for g, w in zip(tree_leaves(carry[0]), jax.tree.leaves(jcarry[0])):
        np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-4)


def _tiny_params(seed=0):
    _, tc = _configs()
    return tc, tb.bert_init(tc, torch.Generator().manual_seed(seed),
                            device="cpu")


def test_bert_forward_shape_and_dtype():
    tc, params = _tiny_params()
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 16))
    logits = tb.bert_forward(params, tokens, tc, device="cpu")
    assert logits.shape == (2, 16, tc.vocab_size)
    assert logits.dtype == torch.float32


def test_bert_bidirectional():
    # Unlike llama, changing a LATER token changes EARLIER logits.
    tc, params = _tiny_params()
    t1 = np.zeros((1, 8), np.int32)
    t2 = t1.copy()
    t2[0, 7] = 5
    l1 = tb.bert_forward(params, t1, tc, device="cpu")
    l2 = tb.bert_forward(params, t2, tc, device="cpu")
    assert not torch.allclose(l1[0, 0], l2[0, 0])


def test_bert_padding_masked_out():
    # Logits at real positions must ignore padding tokens' content.
    tc, params = _tiny_params()
    mask = np.array([[1, 1, 1, 1, 0, 0, 0, 0]])
    t1 = np.zeros((1, 8), np.int32)
    t2 = t1.copy()
    t2[0, 6] = 9  # change only a padded position
    l1 = tb.bert_forward(params, t1, tc, attention_mask=mask, device="cpu")
    l2 = tb.bert_forward(params, t2, tc, attention_mask=mask, device="cpu")
    torch.testing.assert_close(l1[0, :4], l2[0, :4], rtol=0, atol=1e-5)


def test_bert_fully_padded_sample_no_nan():
    # A ragged final batch pads with empty sequences: the loss and every
    # gradient stay finite, and the empty sequence's attention is 0.
    tc, params = _tiny_params()
    tokens = np.zeros((2, 8), np.int32)
    batch = {"tokens": tokens, "targets": tokens,
             "mlm_mask": np.array([[1.0] * 8, [0.0] * 8], np.float32),
             "attention_mask": np.array([[1] * 8, [0] * 8])}
    loss, grads = _value_and_grad(
        lambda p, d: tb.bert_mlm_loss(p, d, tc, device="cpu"), params,
        batch, 1)
    assert torch.isfinite(loss)
    assert all(bool(torch.isfinite(g).all()) for g in tree_leaves(grads))


def test_bert_mlm_loss_finite_and_masked():
    tc, params = _tiny_params()
    tokens = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 16))
    mlm = np.zeros((2, 16), np.float32)
    mlm[:, :4] = 1
    batch = {"tokens": tokens, "targets": tokens, "mlm_mask": mlm}
    assert torch.isfinite(tb.bert_mlm_loss(params, batch, tc, device="cpu"))
    # With no predicted positions, loss is exactly 0 (div guarded).
    batch0 = dict(batch, mlm_mask=np.zeros((2, 16), np.float32))
    assert float(tb.bert_mlm_loss(params, batch0, tc, device="cpu")) == 0.0


def test_configs_mirror_jax():
    for name in ("base", "large"):
        got = dataclasses.asdict(getattr(tb.BertConfig, name)())
        want = dataclasses.asdict(getattr(jb.BertConfig, name)())
        assert got == want, name
    assert dataclasses.asdict(tb.BertConfig.tiny(d_model=32)) == \
        dataclasses.asdict(jb.BertConfig.tiny(d_model=32))
    assert tb.BertConfig.large().head_dim == 64


def test_partition_rules_raise_naming_a8():
    """The rules are ported (they raised naming A8 before): JAX's rules,
    pattern for pattern and spec for spec, and every leaf of the tree
    takes the spec JAX's first match gives it. The mesh path itself is
    held against JAX in ``tests/test_torch_mesh_parallel.py``."""
    import re

    from horovod_tpu_torch.parallel.sharding import param_specs

    got, want = tb.bert_partition_rules(), jb.bert_partition_rules()
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(s) for _, s in got] == [tuple(s) for _, s in want]
    tc, params = _tiny_params()
    specs = param_specs(params, got)
    for path, spec in _flat_specs(specs).items():
        first = next(s for p, s in want if re.search(p, path))
        assert tuple(spec) == tuple(first), path


def _flat_specs(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_specs(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
