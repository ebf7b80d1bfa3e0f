"""The port's hand-written CUDA kernels against their plain versions.

Runs only on a card of compute capability >= 9.0 (the kernels are
built for sm_90a); elsewhere every test skips. ``python3
chip_smoke.py`` is the on-card check at the main path's shapes; this
file adds edge shapes. Tolerances: f32 1e-4; bf16 output 2e-2 (one bf16
ulp of p may differ across summation orders); lse 1e-3. K2/K3 gradients
relative to each gradient's largest entry: f32 1e-4, bf16 2e-2 (the
same f32 products summed in another order, then one bf16 rounding of p
or ds may land differently). K5/K6 relative to the plain version's
largest entry: f32 1e-5, bf16 1e-2 (both sum in f32 and round once, so
an element may differ by one bf16 ulp); an empty group's tgmm slice is
exactly 0. bf16 K1 and K6 run on the wgmma kernels (the route their
wrappers pick from the dtype), f32 on the FMA kernels: each route is
held to the same tolerance.
"""

import pytest
import torch

from horovod_tpu_torch.ops import decode_attention as da
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import grouped_moe as gm

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


# K1 at the model's head dim on the wgmma route: ragged T around the
# 64-row wgmma and 128-row block and kv tiles, one row, a train length;
# n_rep 4 and 2.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 200, 2048])
def test_flash_fwd_wgmma_matches_plain(t, hkv, causal):
    b = 2 if t < 2048 else 1
    q = _rand((b, 16, t, 128), torch.bfloat16, 30)
    k = _rand((b, hkv, t, 128), torch.bfloat16, 31)
    v = _rand((b, hkv, t, 128), torch.bfloat16, 32)
    before = dict(fa._flash_fwd_cuda.launches_by_route)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, causal)
    torch.cuda.synchronize()
    assert fa._flash_fwd_cuda.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 1)
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-3)


def test_flash_fwd_routes_by_dtype():
    """bf16 goes to the wgmma kernel, f32 to the FMA kernel; the FMA
    kernel still takes bf16 when asked by name, and agrees."""
    q = _rand((1, 4, 70, 64), torch.bfloat16, 33)
    kv = _rand((1, 2, 70, 64), torch.bfloat16, 34)
    before = dict(fa._flash_fwd_cuda.launches_by_route)
    o_w, lse_w = fa._flash_fwd_cuda(q, kv, kv, True)
    o_f, lse_f = fa._flash_fwd_cuda(q, kv, kv, True, route="fma")
    fa._flash_fwd_cuda(q.float(), kv.float(), kv.float(), True)
    torch.cuda.synchronize()
    assert fa._flash_fwd_cuda.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "fma": before["fma"] + 2}
    torch.testing.assert_close(o_w.float(), o_f.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse_w, lse_f, rtol=0, atol=1e-3)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        fa._flash_fwd_cuda(q.float(), kv.float(), kv.float(), True,
                           route="wgmma")


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


# (M, K, N, group sizes): M, K and N off the 128-wide tile, empty first,
# middle and last groups, every row in one group, boundaries straddling
# a row tile.
GMM_LAYOUTS = {
    "E1": (37, 48, 40, [37]),
    "E4-empty-first": (37, 48, 40, [0, 12, 15, 10]),
    "E4-empty-middle": (37, 48, 40, [12, 0, 15, 10]),
    "E4-empty-last": (37, 48, 40, [12, 15, 10, 0]),
    "E8-one-group": (37, 48, 40, [0, 0, 0, 37, 0, 0, 0, 0]),
    "E8-ragged": (37, 48, 40, [5, 3, 0, 9, 4, 0, 10, 6]),
    "E4-straddle": (300, 136, 72, [129, 1, 0, 170]),
}

# (M, K, N, group sizes) for the wgmma route's edges: boundaries off the
# 64-row stage and the 128-row tile, empty first/middle/last groups, a
# one-row group, M below one stage, and the smoke's skewed routing at
# narrower widths. K and N are multiples of 8 (TMA's 16-byte rows).
WGMMA_LAYOUTS = {
    "off-64": (300, 192, 136, [70, 130, 100]),
    "off-128": (520, 256, 264, [129, 255, 136]),
    "empty-first": (200, 128, 128, [0, 77, 123]),
    "empty-middle": (200, 128, 128, [77, 0, 123]),
    "empty-last": (200, 128, 128, [77, 123, 0]),
    "one-row": (130, 64, 200, [1, 128, 1]),
    "m-below-64": (40, 72, 56, [10, 30]),
    "skewed": (8192, 256, 512, [0, 5000, 3001, 191]),
}


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("layout", sorted(GMM_LAYOUTS))
def test_grouped_mm_kernels_match_plain(layout, dtype, tol):
    m, k, n, sizes = GMM_LAYOUTS[layout]
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs = _rand((m, k), dtype, 14)
    rhs = _rand((len(sizes), k, n), dtype, 15)
    grad = _rand((m, n), dtype, 16)
    cases = (
        ("gmm", gm._gmm_cuda(lhs, rhs, gs), gm._gmm_reference(lhs, rhs, gs)),
        ("dlhs", gm._gmm_dlhs_cuda(grad, rhs, gs),
         gm._gmm_dlhs_reference(grad, rhs, gs)),
        ("tgmm", gm._tgmm_cuda(lhs, grad, gs),
         gm._tgmm_reference(lhs, grad, gs)))
    torch.cuda.synchronize()
    for name, got, want in cases:
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert _rel(got, want) <= tol, f"{name}: relative error"
    for e, size in enumerate(sizes):
        if size == 0:
            assert not cases[2][1][e].any()


@pytest.mark.parametrize("layout", sorted(WGMMA_LAYOUTS))
def test_grouped_bwd_wgmma_matches_plain(layout):
    m, k, n, sizes = WGMMA_LAYOUTS[layout]
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs = _rand((m, k), torch.bfloat16, 35)
    rhs = _rand((len(sizes), k, n), torch.bfloat16, 36)
    grad = _rand((m, n), torch.bfloat16, 37)
    before = (dict(gm._gmm_dlhs_cuda.launches_by_route),
              dict(gm._tgmm_cuda.launches_by_route))
    dlhs = gm._gmm_dlhs_cuda(grad, rhs, gs)
    drhs = gm._tgmm_cuda(lhs, grad, gs)
    torch.cuda.synchronize()
    for fn, was in zip((gm._gmm_dlhs_cuda, gm._tgmm_cuda), before):
        assert fn.launches_by_route == dict(was, wgmma=was["wgmma"] + 1)
    assert _rel(dlhs, gm._gmm_dlhs_reference(grad, rhs, gs)) <= 1e-2
    assert _rel(drhs, gm._tgmm_reference(lhs, grad, gs)) <= 1e-2
    for e, size in enumerate(sizes):
        if size == 0:
            assert not drhs[e].any()


@pytest.mark.parametrize("half", ["dlhs", "tgmm"])
def test_grouped_bwd_wgmma_raises_on_widths_off_8(half):
    gs = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    lhs = _rand((8, 130), torch.bfloat16, 38)
    rhs = _rand((2, 130, 64), torch.bfloat16, 39)
    grad = _rand((8, 64), torch.bfloat16, 40)
    with pytest.raises(ValueError, match="multiples of 8"):
        if half == "dlhs":
            gm._gmm_dlhs_cuda(grad, rhs, gs)
        else:
            gm._tgmm_cuda(lhs, grad, gs)
    # The FMA kernels, asked by name, take any width.
    assert _rel(gm._gmm_dlhs_cuda(grad, rhs, gs, route="fma"),
                gm._gmm_dlhs_reference(grad, rhs, gs)) <= 1e-2
    assert _rel(gm._tgmm_cuda(lhs, grad, gs, route="fma"),
                gm._tgmm_reference(lhs, grad, gs)) <= 1e-2


def test_grouped_mm_backward_launches_one_dlhs_and_one_tgmm():
    gs = torch.tensor([3, 0, 5], dtype=torch.int32, device="cuda")
    lhs = _rand((8, 16), torch.float32, 17).requires_grad_(True)
    rhs = _rand((3, 16, 24), torch.float32, 18).requires_grad_(True)
    out = gm._grouped_mm(lhs, rhs, gs, "moe_gate_act")
    before = (gm._gmm_cuda.launches, gm._gmm_dlhs_cuda.launches,
              gm._tgmm_cuda.launches)
    out.sum().backward()
    assert (gm._gmm_cuda.launches, gm._gmm_dlhs_cuda.launches,
            gm._tgmm_cuda.launches) == (before[0], before[1] + 1,
                                        before[2] + 1)
    assert lhs.grad.shape == lhs.shape and rhs.grad.shape == rhs.shape


def test_grouped_moe_ffn_runs_without_host_sync():
    """The MoE FFN, forward and backward, never waits on the host: no
    wrapper reads group_sizes, and the routing avoids bincount/one_hot
    (both read their input's range on the host on CUDA)."""
    from horovod_tpu_torch.models.llama import LlamaConfig

    c = LlamaConfig.tiny_moe(dtype="bfloat16", d_model=128, d_ff=256)
    e, d, f = c.n_experts, c.d_model, c.d_ff
    lp = {"router": _rand((d, e), torch.float32, 19),
          "moe_gate": _rand((e, d, f), torch.bfloat16, 20),
          "moe_up": _rand((e, d, f), torch.bfloat16, 21),
          "moe_down": _rand((e, f, d), torch.bfloat16, 22)}
    for w in lp.values():
        w.requires_grad_(True)
    h = _rand((2, 40, d), torch.bfloat16, 23).requires_grad_(True)

    def run():
        y, aux = gm.grouped_moe_ffn(h, lp, c)
        return torch.autograd.grad(y.float().sum() + aux, [h, *lp.values()])

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
