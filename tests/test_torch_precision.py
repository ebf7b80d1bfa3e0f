"""The port's fused Adam optimizers against the JAX package's.

``fused_adam`` and ``fused_master_adam`` from ``horovod_tpu_torch.
parallel.precision`` against ``horovod_tpu.parallel.fused_adam`` /
``fused_master_adam`` over 3 steps on the same numpy-made params and
grads. Tolerances: f32 rtol 1e-6 (the same f32 expression, evaluated by
two libraries); bf16 params and moments to one bf16 unit in the last
place (2**-7 relative: both compute in f32 and round what they store,
and an f32 difference of one ulp can straddle a bf16 rounding
boundary). The master's compute cast must equal the master rounded to
bf16, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.parallel import fused_adam as j_fused_adam
from horovod_tpu.parallel import fused_master_adam as j_fused_master_adam
from horovod_tpu_torch.models.convert import from_jax_params
from horovod_tpu_torch.parallel import precision

SHAPES = {"embed": (16, 8), "layers": {"w": (2, 8, 8), "norm": (2, 8)}}


def _tree(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


def _to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def _to_port(jtree):
    return from_jax_params(jax.tree.map(np.asarray, jtree), device="cpu")


def _grads(step):
    return _tree(np.random.default_rng(100 + step), SHAPES, 0.1)


def _assert_close(got_tree, want_tree, dtype):
    for g, w in zip(_leaves(got_tree), jax.tree.leaves(want_tree)):
        assert g.dtype == getattr(torch, dtype)
        if dtype == "float32":
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_allclose(_np(g), _np(w), rtol=2 ** -7,
                                       atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_adam_matches_jax(dtype):
    jparams = _to_jax(_tree(np.random.default_rng(0), SHAPES), dtype)
    jopt = j_fused_adam(1e-2)
    jst = jopt.init(jparams)
    params = _to_port(jparams)
    opt = precision.fused_adam(1e-2)
    st = opt.init(params)
    for step in range(3):
        g = _grads(step)
        jparams, jst = jopt.apply(jparams, _to_jax(g, dtype), jst)
        params, st = opt.apply(params, _to_port(_to_jax(g, dtype)), st)
    assert int(st.count) == 3 and st.count.dtype == torch.int32
    _assert_close(params, jparams, dtype)
    _assert_close(st.mu, jst.mu, dtype)
    _assert_close(st.nu, jst.nu, dtype)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
def test_fused_master_adam_matches_jax(grad_dtype):
    jparams = _to_jax(_tree(np.random.default_rng(1), SHAPES), "float32")
    jopt = j_fused_master_adam(1e-2)
    jst = jopt.init(jparams)
    jcompute = jopt.compute_params(jst)
    opt = precision.fused_master_adam(1e-2)
    st = opt.init(_to_port(jparams))
    compute = opt.compute_params(st)
    assert all(c.dtype == torch.bfloat16 for c in _leaves(compute))
    for step in range(3):
        g = _to_jax(_grads(step), grad_dtype)
        jcompute, jst = jopt.apply(jcompute, g, jst)
        compute, st = opt.apply(compute, _to_port(g), st)
    assert int(st.count) == 3
    _assert_close(st.master, jst.master, "float32")
    _assert_close(st.mu, jst.mu, "float32")
    _assert_close(st.nu, jst.nu, "float32")
    _assert_close(compute, jcompute, "bfloat16")
    # The compute cast IS the master rounded to bf16, bitwise.
    for c, m in zip(_leaves(compute), _leaves(st.master)):
        assert torch.equal(c, m.to(torch.bfloat16))


def test_apply_updates_in_place_and_init_copies():
    """The apply writes params and moments in place (the port's
    donation); master init never aliases the caller's f32 params."""
    params = _to_port(_to_jax(_tree(np.random.default_rng(2), SHAPES),
                              "float32"))
    opt = precision.fused_adam(1e-2)
    st = opt.init(params)
    ptrs = [p.data_ptr() for p in _leaves(params)]
    new, st2 = opt.apply(params, _to_port(_grads(0)), st)
    assert [p.data_ptr() for p in _leaves(new)] == ptrs
    assert st2.mu is st.mu and int(st2.count) == 1
    mst = precision.fused_master_adam(1e-2).init(params)
    assert all(m.data_ptr() != p.data_ptr()
               for m, p in zip(_leaves(mst.master), _leaves(params)))
