"""The port's hand-written CUDA kernels against their plain versions.

Runs only on a card of compute capability >= 9.0 (the kernels are
built for sm_90a); elsewhere every test skips. ``python3
chip_smoke.py`` is the on-card check at the main path's shapes; this
file adds edge shapes. Tolerances: f32 1e-4; bf16 output 2e-2 (one bf16
ulp of p may differ across summation orders); lse 1e-3. K2/K3 gradients
relative to each gradient's largest entry: f32 1e-4, bf16 2e-2 (the
same f32 products summed in another order, then one bf16 rounding of p
or ds may land differently).
"""

import pytest
import torch

from horovod_tpu_torch.ops import decode_attention as da
from horovod_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda_sm90


@pytest.fixture(autouse=True)
def _needs_sm90():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")


def _rand(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,hkv,t,d,causal", [
    (2, 4, 2, 37, 16, True), (1, 8, 8, 64, 32, False),
    (3, 16, 4, 129, 64, True), (2, 16, 4, 200, 128, True)])
def test_flash_fwd_matches_plain(b, h, hkv, t, d, causal, dtype, tol):
    q = _rand((b, h, t, d), dtype, 0)
    k = _rand((b, hkv, t, d), dtype, 1)
    v = _rand((b, hkv, t, d), dtype, 2)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hkv,n_rep,s,d,pos", [
    (3, 2, 1, 12, 16, 0), (2, 2, 4, 300, 64, 150),
    (1, 4, 4, 5000, 128, 4999), (2, 1, 16, 129, 256, 128)])
def test_decode_attention_matches_plain(b, hkv, n_rep, s, d, pos, dtype,
                                        tol):
    q = _rand((b, 1, hkv * n_rep, d), dtype, 3)
    ck = _rand((b, hkv, s, d), dtype, 4)
    cv = _rand((b, hkv, s, d), dtype, 5)
    out = da._decode_attention_cuda(q, ck, cv, pos)
    ref = da._decode_attention_reference(q, ck, cv, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hkv,n_rep,t,d,causal", [
    (2, 2, 1, 37, 16, True), (1, 2, 4, 77, 64, True),
    (2, 1, 8, 130, 128, True), (1, 4, 4, 100, 128, False),
    (3, 2, 4, 64, 32, False)])
def test_flash_bwd_matches_plain(b, hkv, n_rep, t, d, causal, dtype, tol):
    h = hkv * n_rep
    q = _rand((b, h, t, d), dtype, 8)
    k = _rand((b, hkv, t, d), dtype, 9)
    v = _rand((b, hkv, t, d), dtype, 10)
    do = _rand((b, h, t, d), dtype, 11)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, causal)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= tol, f"{name}: relative error {err}"


def test_wrappers_count_launches():
    q = _rand((1, 2, 8, 16), torch.float32, 6)
    kv = _rand((1, 1, 8, 16), torch.float32, 7)
    before = fa._flash_fwd_cuda.launches
    fa._flash_fwd_impl(q, kv, kv, True)
    assert fa._flash_fwd_cuda.launches == before + 1
    before = da._decode_attention_cuda.launches
    da.decode_attention(q[:, :, :1].transpose(1, 2).contiguous(), kv, kv, 3)
    assert da._decode_attention_cuda.launches == before + 1


def test_backward_launches_k2_and_k3_once_each():
    q = _rand((1, 8, 2, 16), torch.float32, 12).requires_grad_(True)
    kv = _rand((1, 8, 1, 16), torch.float32, 13).requires_grad_(True)
    out = fa.flash_attention(q, kv, kv, causal=True)
    before = (fa._flash_fwd_cuda.launches, fa._flash_bwd_dkv_cuda.launches,
              fa._flash_bwd_dq_cuda.launches)
    out.sum().backward()
    assert (fa._flash_fwd_cuda.launches, fa._flash_bwd_dkv_cuda.launches,
            fa._flash_bwd_dq_cuda.launches) == (before[0], before[1] + 1,
                                                before[2] + 1)
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
