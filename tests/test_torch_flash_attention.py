"""The port's flash-attention forward against the JAX package.

The plain ``_flash_fwd_reference`` (what the K1 wrapper runs for CPU
tensors, and the kernel's yardstick on the card) is held against the
Pallas ``_fwd_kernel`` run in interpret mode, o AND lse; the public
``flash_attention`` against JAX's at a T that is not a power of two.
Tolerances: f32 at 2e-4 (the JAX tests' own), bf16 at 2e-2 (one bf16
rounding of p can differ between one global max and a running max).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu_torch.ops import flash_attention as port

fa_mod = importlib.import_module("horovod_tpu.ops.flash_attention")

TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.fixture(autouse=True)
def _interpret_mode():
    fa_mod._INTERPRET = True
    yield
    fa_mod._INTERPRET = False


def _inputs(seed, b, h, hkv, t, d, dtype, layout="bhtd"):
    rng = np.random.default_rng(seed)
    if layout == "bhtd":
        shapes = [(b, h, t, d), (b, hkv, t, d), (b, hkv, t, d)]
    else:
        shapes = [(b, t, h, d), (b, t, hkv, d), (b, t, hkv, d)]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tt


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("block", [32, 16])
def test_reference_matches_pallas_kernel(causal, n_rep, dtype, block):
    """block 32 = one kv block (the kernel's function exactly); block
    16 = two, so the Pallas kernel's running max rescales once."""
    hkv = 2
    (q, k, v), (tq, tk, tv) = _inputs(0, 2, hkv * n_rep, hkv, 32, 16,
                                      dtype)
    o, lse = fa_mod._flash_fwd_impl(q, k, v, None, causal, block, block)
    o_t, lse_t = port._flash_fwd_reference(tq, tk, tv, causal)
    assert o_t.dtype == tq.dtype and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == tuple(lse.shape)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(o_t), _np(o), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(lse_t), _np(lse), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_public_flash_attention_ragged_t(dtype):
    """T = 37: the JAX path picks a block dividing T; the port takes any
    T (on the card K1 masks the ragged tile)."""
    (q, k, v), (tq, tk, tv) = _inputs(1, 2, 4, 2, 37, 16, dtype,
                                      layout="bthd")
    ref = fa_mod.flash_attention(q, k, v, causal=True)
    out = port.flash_attention(tq, tk, tv, causal=True)
    assert out.shape == tq.shape and out.dtype == tq.dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(out), _np(ref), rtol=tol, atol=tol)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """The wrapper picks the plain version only because the tensor
    lies on the CPU: nothing builds or launches a kernel."""
    def no_build(name):
        raise AssertionError(f"kernel {name} requested for CPU tensors")

    monkeypatch.setattr(port._build, "load", no_build)
    launches = port._flash_fwd_cuda.launches
    _, (tq, tk, tv) = _inputs(2, 1, 2, 1, 8, 16, "float32")
    o, lse = port._flash_fwd_impl(tq, tk, tv, True)
    assert o.shape == tq.shape and lse.shape == (1, 2, 8, 1)
    assert port._flash_fwd_cuda.launches == launches


def test_kernel_wrapper_rejects_cpu_tensors():
    _, (tq, tk, tv) = _inputs(3, 1, 2, 1, 8, 16, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        port._flash_fwd_cuda(tq, tk, tv, True)

