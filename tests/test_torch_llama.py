"""The port's Llama pieces against the JAX package: the config mirror
(dense and MoE presets), ``llama_init``'s dense tree (the MoE tree:
test_torch_moe_llama.py), ``_rmsnorm``/``_rope``/``_ffn`` at f32 and bf16,
and the bit-exact JAX -> torch parameter conversion.

Inputs are made with numpy and handed to both. Tolerances: f32 at 1e-5
(both compute in f32; only summation order differs), bf16 at 2e-2 (a
few bf16 roundings land differently between the two frameworks).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import llama as jl
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.models.convert import from_jax_params

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _both(a, dtype):
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(
        getattr(torch, dtype))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_config_fields_mirror_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jl.LlamaConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tl.LlamaConfig)}
    assert jf == tf


@pytest.mark.parametrize("preset", ["tiny", "llama3_8b", "tiny_moe",
                                    "mixtral_8x7b"])
def test_presets_mirror_jax(preset):
    j = getattr(jl.LlamaConfig, preset)()
    t = getattr(tl.LlamaConfig, preset)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert j.head_dim == t.head_dim
    assert t.compute_dtype == torch.bfloat16


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_llama_init_tree_matches_jax(param_dtype):
    jc = jl.LlamaConfig.tiny(param_dtype=param_dtype)
    tc = tl.LlamaConfig.tiny(param_dtype=param_dtype)
    jp = _flat(jl.llama_init(jc, jax.random.PRNGKey(0)))
    tp = _flat(tl.llama_init(tc, torch.Generator().manual_seed(0),
                             device="cpu"))
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert tuple(jp[k].shape) == tuple(tp[k].shape), k
        assert tp[k].dtype == getattr(torch, param_dtype), k
    # Same fan-in scaling: the stds agree to sampling noise.
    for k in ("layers/wq", "layers/w_down", "lm_head", "embed"):
        assert np.std(_np(tp[k])) == pytest.approx(
            np.std(_np(jp[k])), rel=0.1), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x, tx = _both(rng.standard_normal((2, 5, 64)).astype(np.float32) * 3,
                  dtype)
    s, ts = _both(rng.uniform(0.5, 1.5, 64).astype(np.float32), dtype)
    ref = jl._rmsnorm(x, s, 1e-5)
    out = tl._rmsnorm(tx, ts, 1e-5)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x, tx = _both(rng.standard_normal((2, 6, 4, 16)).astype(np.float32),
                  dtype)
    pos = np.stack([np.arange(6), np.arange(6) + 37]).astype(np.int32)
    ref = jl._rope(x, jnp.asarray(pos), 10000.0)
    out = tl._rope(tx, torch.from_numpy(pos), 10000.0)
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_ffn_matches_jax(dtype):
    jc = jl.LlamaConfig.tiny(dtype=dtype)
    tc = tl.LlamaConfig.tiny(dtype=dtype)
    rng = np.random.default_rng(2)
    lp_np = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
             for k, s in (("w_gate", (64, 128)), ("w_up", (64, 128)),
                          ("w_down", (128, 64)))}
    h, th = _both(rng.standard_normal((2, 3, 64)).astype(np.float32),
                  dtype)
    ref, _ = jl._ffn(h, {k: jnp.asarray(v) for k, v in lp_np.items()}, jc)
    out, aux = tl._ffn(th, {k: torch.from_numpy(v)
                            for k, v in lp_np.items()}, tc)
    assert out.dtype == th.dtype and float(aux) == 0.0
    np.testing.assert_allclose(_np(out), _np(ref), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trips_bit_exactly(param_dtype):
    jc = jl.LlamaConfig.tiny(param_dtype=param_dtype)
    jp = jl.llama_init(jc, jax.random.PRNGKey(3))
    tp = _flat(from_jax_params(jax.tree.map(np.asarray, jp),
                               device="cpu"))
    for k, a in _flat(jp).items():
        a = np.asarray(a)
        t = tp[k]
        assert t.dtype == getattr(torch, param_dtype), k
        if param_dtype == "bfloat16":
            back = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(back, a.view(np.uint16), k)
        else:
            np.testing.assert_array_equal(t.numpy(), a, k)
