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
exactly 0. bf16 K1-K6 run on the wgmma kernels (the route their
wrappers pick from the dtype), f32 on the FMA kernels: each route is held
to the same tolerance. K3, K4 and K5's split-K path give the same bits on
every launch (fixed-order sums, no atomics). The MoE router breaks exact
ties as ``lax.top_k`` does, lower expert index first, on the card too.
K1-K3's bias variant is held to the same tolerances on both routes, with
exact zeros for a sequence that is all padding, at BERT-Large's heads and
its tensor=2 and tensor=4 shards' (H8, H4). K5 and K6 run at Mixtral's
tensor=2 and tensor=4 expert shards. The lane's wire codecs
(bf16 and int8 encode, decode-accumulate and decode-scale) match their
plain versions bit for bit on packed and padded multi-segment layouts,
infinities, denormals and the encoders' NaN payloads included; a NaN
that a decoder's arithmetic makes is NaN on both, with the card's
canonical payload. The Adam kernel (both variants, bf16 and f32) gives
its plain version's bits over three successive steps, at odd lengths
and on misaligned views.
"""

import pytest
import torch

from horovod_tpu_torch.ops import adam
from horovod_tpu_torch.ops import decode_attention as da
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import grouped_moe as gm
from horovod_tpu_torch.ops import wire_codec as wc

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


# K5 on the wgmma route at small and ragged M: (M, K, N, group sizes).
# Rows around the 64-row warpgroup and 128-row tile, empty groups, groups
# that leave rows uncovered, K and N off 128.
K5_LAYOUTS = {
    "m1": (1, 2048, 4096, [0, 1, 0, 0]),
    "m63": (63, 192, 136, [20, 0, 43]),
    "m64": (64, 256, 264, [64, 0, 0]),
    "m65": (65, 136, 128, [0, 30, 35]),
    "m127": (127, 128, 200, [60, 7, 50]),  # row 117.. uncovered
    "m129": (129, 4096, 2048, [9, 100, 0, 20]),
    "uncovered": (100, 64, 72, [10, 0, 30]),
}


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("proj", ["gate/up", "down"])
def test_grouped_kernels_at_mixtral_tensor_shards(t, proj):
    """K5 and both halves of K6 on the wgmma route at Mixtral's experts
    (d4096, F 14336, 8 experts) as a ``tensor=t`` shard of the grouped
    dispatch takes them: B1 x T2048 top-2 (an fsdp=2 rank's 4096 rows),
    gate/up at F/t columns, down at F/t rows."""
    sizes = [560, 470, 530, 490, 515, 505, 520, 506]
    k, n = (4096, 14336 // t) if proj == "gate/up" else (14336 // t, 4096)
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs = _rand((sum(sizes), k), torch.bfloat16, 51)
    rhs = (_rand((len(sizes), k, n), torch.bfloat16, 52).float()
           * k ** -0.5).bfloat16()
    grad = _rand((sum(sizes), n), torch.bfloat16, 53)
    before = [dict(fn.launches_by_route) for fn in (
        gm._gmm_cuda, gm._gmm_dlhs_cuda, gm._tgmm_cuda)]
    cases = (("gmm", gm._gmm_cuda(lhs, rhs, gs),
              gm._gmm_reference(lhs, rhs, gs)),
             ("dlhs", gm._gmm_dlhs_cuda(grad, rhs, gs),
              gm._gmm_dlhs_reference(grad, rhs, gs)),
             ("tgmm", gm._tgmm_cuda(lhs, grad, gs),
              gm._tgmm_reference(lhs, grad, gs)))
    torch.cuda.synchronize()
    for fn, was in zip((gm._gmm_cuda, gm._gmm_dlhs_cuda, gm._tgmm_cuda),
                       before):
        assert fn.launches_by_route == dict(was, wgmma=was["wgmma"] + 1)
    for name, got, want in cases:
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert _rel(got, want) <= 1e-2, f"{name}: relative error"


@pytest.mark.parametrize("layout", sorted(K5_LAYOUTS))
def test_gmm_wgmma_matches_plain(layout):
    m, k, n, sizes = K5_LAYOUTS[layout]
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs = _rand((m, k), torch.bfloat16, 41)
    rhs = (_rand((len(sizes), k, n), torch.bfloat16, 42).float()
           * k ** -0.5).bfloat16()
    before = dict(gm._gmm_cuda.launches_by_route)
    got = gm._gmm_cuda(lhs, rhs, gs)
    want = gm._gmm_reference(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert gm._gmm_cuda.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 1)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert _rel(got, want) <= 1e-2
    covered = sum(sizes)
    assert not got[covered:].any(), "rows no group covers must be 0"


def test_gmm_wgmma_every_group_empty():
    """M = 0 launches nothing; rows with every group empty stay 0."""
    rhs = _rand((4, 128, 256), torch.bfloat16, 43)
    zero = torch.zeros(4, dtype=torch.int32, device="cuda")
    out = gm._gmm_cuda(_rand((0, 128), torch.bfloat16, 44), rhs, zero)
    assert out.shape == (0, 256)
    out = gm._gmm_cuda(_rand((40, 128), torch.bfloat16, 45), rhs, zero)
    torch.cuda.synchronize()
    assert out.shape == (40, 256) and not out.any()


@pytest.mark.parametrize("k,n", [(2048, 4096), (4096, 2048)])
def test_gmm_split_k_matches_plain_and_repeats_its_bits(k, n):
    """A decode step's 32 routed rows: the plan splits K; the result is
    within tolerance and the same bits on a second launch."""
    sizes = [9, 7, 10, 6]
    m = sum(sizes)
    assert gm._gmm_split_k(m, k, n, 4, gm._sm_count(
        torch.device("cuda", torch.cuda.current_device()))) > 1
    gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
    lhs = _rand((m, k), torch.bfloat16, 46)
    rhs = (_rand((4, k, n), torch.bfloat16, 47).float()
           * k ** -0.5).bfloat16()
    a = gm._gmm_cuda(lhs, rhs, gs)
    b = gm._gmm_cuda(lhs, rhs, gs)
    want = gm._gmm_reference(lhs, rhs, gs)
    torch.cuda.synchronize()
    assert _rel(a, want) <= 1e-2
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    # Fewer rows than the groups name: the uncovered tail is exactly 0.
    short = torch.tensor([9, 7, 10, 0], dtype=torch.int32, device="cuda")
    c = gm._gmm_cuda(lhs, rhs, short)
    torch.cuda.synchronize()
    assert not c[26:].any()
    assert _rel(c[:26], gm._gmm_reference(lhs, rhs, short)[:26]) <= 1e-2


def test_gmm_routes_by_dtype_and_raises_on_widths_off_8():
    gs = torch.tensor([3, 5], dtype=torch.int32, device="cuda")
    lhs = _rand((8, 64), torch.bfloat16, 48)
    rhs = _rand((2, 64, 72), torch.bfloat16, 49)
    before = dict(gm._gmm_cuda.launches_by_route)
    w = gm._gmm_cuda(lhs, rhs, gs)
    f = gm._gmm_cuda(lhs, rhs, gs, route="fma")
    gm._gmm_cuda(lhs.float(), rhs.float(), gs)
    torch.cuda.synchronize()
    assert gm._gmm_cuda.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "fma": before["fma"] + 2}
    assert _rel(w, f) <= 1e-2
    with pytest.raises(ValueError, match="multiples of 8"):
        gm._gmm_cuda(lhs, _rand((2, 64, 70), torch.bfloat16, 50), gs)
    with pytest.raises(ValueError, match="route 'wgmma'"):
        gm._gmm_cuda(lhs.float(), rhs.float(), gs, route="wgmma")


# K2 at the model's head dims on the wgmma route: ragged T around the
# 64-query tile and 128-key block, one row, a train length; n_rep 4 and
# 2; causal or not.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 8])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 127, 129, 200, 2048])
def test_flash_bwd_dkv_wgmma_matches_plain(t, hkv, causal, d):
    b = 2 if t < 2048 else 1
    q = _rand((b, 16, t, d), torch.bfloat16, 51)
    k = _rand((b, hkv, t, d), torch.bfloat16, 52)
    v = _rand((b, hkv, t, d), torch.bfloat16, 53)
    do = _rand((b, 16, t, d), torch.bfloat16, 54)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal)
    delta = fa._delta(o, do)
    before = dict(fa._flash_bwd_dkv_cuda.launches_by_route)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal)
    _, dk_ref, dv_ref = fa._flash_bwd_reference(q, k, v, o, lse, do, causal)
    torch.cuda.synchronize()
    assert fa._flash_bwd_dkv_cuda.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 1)
    for name, g, w in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        # Relative to the reference's largest entry, or to 1e-3 where that
        # is smaller: with one key (T = 1) dp equals delta, so dk is 0 up
        # to each side's rounding and there is no scale of its own.
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp_min(1e-3))
        assert err <= 2e-2, f"{name}: relative error {err}"


def test_flash_bwd_dkv_routes_by_dtype():
    """bf16 goes to the wgmma kernel, f32 to the FMA kernel; the FMA
    kernel still takes bf16 when asked by name, and agrees."""
    q = _rand((1, 4, 70, 64), torch.bfloat16, 55)
    kv = _rand((1, 2, 70, 64), torch.bfloat16, 56)
    o, lse = fa._flash_fwd_cuda(q, kv, kv, True)
    delta = fa._delta(o, q)
    before = dict(fa._flash_bwd_dkv_cuda.launches_by_route)
    w = fa._flash_bwd_dkv_cuda(q, kv, kv, q, lse, delta, True)
    f = fa._flash_bwd_dkv_cuda(q, kv, kv, q, lse, delta, True, route="fma")
    q32, kv32 = q.float(), kv.float()
    o32, lse32 = fa._flash_fwd_cuda(q32, kv32, kv32, True)
    fa._flash_bwd_dkv_cuda(q32, kv32, kv32, q32, lse32, fa._delta(o32, q32),
                           True)
    torch.cuda.synchronize()
    assert fa._flash_bwd_dkv_cuda.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "fma": before["fma"] + 2}
    for a, b in zip(w, f):
        assert _rel(a, b) <= 2e-2
    with pytest.raises(ValueError, match="route 'wgmma'"):
        fa._flash_bwd_dkv_cuda(q32, kv32, kv32, q32, lse32, lse32, True,
                               route="wgmma")


# K3 on the wgmma route: ragged T around the 64-key tile and the 128-row
# block, one row, a train length; every head dim and n_rep; causal or not.
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n_rep", [1, 2, 4, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 37, 63, 64, 65, 130, 2048])
def test_flash_bwd_dq_wgmma_matches_plain(t, d, n_rep, causal):
    b, hkv = (1, 2) if t == 2048 else (2, 2)
    h = hkv * n_rep
    q = _rand((b, h, t, d), torch.bfloat16, 57)
    k = _rand((b, hkv, t, d), torch.bfloat16, 58)
    v = _rand((b, hkv, t, d), torch.bfloat16, 59)
    do = _rand((b, h, t, d), torch.bfloat16, 60)
    o, lse = fa._flash_fwd_cuda(q, k, v, causal)
    delta = fa._delta(o, do)
    before = dict(fa._flash_bwd_dq_cuda.launches_by_route)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    again = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal)
    dq_ref = fa._flash_bwd_reference(q, k, v, o, lse, do, causal)[0]
    torch.cuda.synchronize()
    assert fa._flash_bwd_dq_cuda.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 2)
    assert dq.shape == dq_ref.shape and dq.dtype == dq_ref.dtype
    # Relative to the reference's largest entry, floored at 1e-3 as K2's
    # test does (at T = 1 there is a single key and dq may be ~0).
    err = float((dq.float() - dq_ref.float()).abs().max()
                / dq_ref.float().abs().max().clamp_min(1e-3))
    assert err <= 2e-2, f"dq: relative error {err}"
    assert torch.equal(dq.view(torch.int16), again.view(torch.int16))


def test_flash_bwd_dq_routes_by_dtype():
    """bf16 goes to the wgmma kernel, f32 to the FMA kernel; the FMA
    kernel still takes bf16 when asked by name, and agrees."""
    q = _rand((1, 4, 70, 64), torch.bfloat16, 61)
    kv = _rand((1, 2, 70, 64), torch.bfloat16, 62)
    o, lse = fa._flash_fwd_cuda(q, kv, kv, True)
    delta = fa._delta(o, q)
    before = dict(fa._flash_bwd_dq_cuda.launches_by_route)
    w = fa._flash_bwd_dq_cuda(q, kv, kv, q, lse, delta, True)
    f = fa._flash_bwd_dq_cuda(q, kv, kv, q, lse, delta, True, route="fma")
    q32, kv32 = q.float(), kv.float()
    o32, lse32 = fa._flash_fwd_cuda(q32, kv32, kv32, True)
    fa._flash_bwd_dq_cuda(q32, kv32, kv32, q32, lse32, fa._delta(o32, q32),
                          True)
    torch.cuda.synchronize()
    assert fa._flash_bwd_dq_cuda.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "fma": before["fma"] + 2}
    assert _rel(w, f) <= 2e-2
    with pytest.raises(ValueError, match="K3 route 'wgmma'"):
        fa._flash_bwd_dq_cuda(q32, kv32, kv32, q32, lse32, lse32, True,
                              route="wgmma")


# K4 on the wgmma route: the FMA test's four shapes (one slot; n_rep 16
# at D256), both generate paths' decode steps (dense Hkv4 n_rep4 and MoE
# Hkv8 n_rep2 at S192, and at pos 0), a long cache over a 16-block
# cluster, one whose last three cluster ranks get no tile (65 tiles over
# 16 blocks of 5), and one whose scores spill to the f32 scratch.
K4_SHAPES = {
    "b3-s12-d16-pos0": (3, 2, 1, 12, 16, 0),
    "b2-s300-d64": (2, 2, 4, 300, 64, 150),
    "b1-s5000": (1, 4, 4, 5000, 128, 4999),
    "b2-rep16-d256": (2, 1, 16, 129, 256, 128),
    "dense-decode": (16, 4, 4, 192, 128, 150),
    "moe-decode": (16, 8, 2, 192, 128, 150),
    "dense-pos0": (16, 4, 4, 192, 128, 0),
    "moe-pos0": (16, 8, 2, 192, 128, 0),
    "b1-s32768": (1, 4, 4, 32768, 128, 32767),
    "empty-ranks": (1, 1, 4, 4160, 128, 4159),
    "spill": (1, 1, 16, 40000, 128, 39999),
}


@pytest.mark.parametrize("shape", sorted(K4_SHAPES))
def test_decode_attention_wgmma_matches_plain(shape):
    b, hkv, n_rep, s, d, pos = K4_SHAPES[shape]
    q = _rand((b, 1, hkv * n_rep, d), torch.bfloat16, 63)
    ck = _rand((b, hkv, s, d), torch.bfloat16, 64)
    cv = _rand((b, hkv, s, d), torch.bfloat16, 65)
    before = dict(da._decode_attention_cuda.launches_by_route)
    out = da._decode_attention_cuda(q, ck, cv, pos)
    again = da._decode_attention_cuda(q, ck, cv, pos)
    ref = da._decode_attention_reference(q, ck, cv, pos)
    torch.cuda.synchronize()
    assert da._decode_attention_cuda.launches_by_route == dict(
        before, wgmma=before["wgmma"] + 2)
    assert out.shape == ref.shape and out.dtype == ref.dtype
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    assert torch.equal(out.view(torch.int16), again.view(torch.int16))


def test_decode_attention_spill_shape_spills():
    """The spill case above does take the f32-scratch schedule."""
    dev = torch.cuda.current_device()
    _, _, spill = da._decode_plan(1, 16, 40000, *da._card(dev, 16, 128))
    assert spill


def test_decode_attention_routes_by_dtype():
    """bf16 goes to the wgmma kernel, f32 to the FMA kernel; the FMA
    kernel still takes bf16 when asked by name, and agrees."""
    q = _rand((2, 1, 8, 64), torch.bfloat16, 66)
    ck = _rand((2, 2, 100, 64), torch.bfloat16, 67)
    cv = _rand((2, 2, 100, 64), torch.bfloat16, 68)
    before = dict(da._decode_attention_cuda.launches_by_route)
    w = da._decode_attention_cuda(q, ck, cv, 80)
    f = da._decode_attention_cuda(q, ck, cv, 80, route="fma")
    da._decode_attention_cuda(q.float(), ck.float(), cv.float(), 80)
    torch.cuda.synchronize()
    assert da._decode_attention_cuda.launches_by_route == {
        "wgmma": before["wgmma"] + 1, "fma": before["fma"] + 2}
    torch.testing.assert_close(w.float(), f.float(), rtol=0, atol=2e-2)
    with pytest.raises(ValueError, match="K4 route 'wgmma'"):
        da._decode_attention_cuda(q.float(), ck.float(), cv.float(), 80,
                                  route="wgmma")


@pytest.mark.parametrize("e", [4, 8, 64])
def test_moe_route_breaks_exact_ties_like_lax_top_k(e):
    """torch.sort(stable=True) on the card ranks equal probabilities by
    expert index, as lax.top_k does: columns 0 and 1 of the router are
    equal (a tie in every row), and zero rows tie across all E."""
    from horovod_tpu_torch.models.llama import moe_route

    h = _rand((64, 64), torch.float32, 69)
    h[:5] = 0.0
    w = _rand((64, e), torch.float32, 70) * 64 ** -0.5
    w[:, 1] = w[:, 0]
    probs = torch.softmax(h @ w, -1)
    assert bool((probs[:, 0] == probs[:, 1]).all())
    for k in (1, 2):
        _, idx, _ = moe_route(h, w, k)
        # The stable order computed on the host from the card's own
        # probabilities: descending, ties by index.
        want = torch.from_numpy(
            (-probs.cpu().numpy()).argsort(-1, kind="stable")[:, :k])
        assert torch.equal(idx.cpu().long(), want)
        assert torch.equal(idx[:5].cpu().long(),
                           torch.arange(k).expand(5, k))


# The bias variant of K1-K3 (BERT's padding mask) on both routes against
# the plain versions: a padding bias with the last sequence all padding (o
# and every gradient exactly 0 there), and a random bias N(0, 3^2) on every
# key, which catches a kernel that adds the bias on masked tiles only.
# Shapes: BERT-Large's attention (H16 T512 D64, non-causal, batch cut),
# ragged T around the tiles, causal, GQA, each head dim.
BIAS_SHAPES = [(3, 16, 16, 512, 64, False), (3, 4, 2, 77, 64, False),
               (2, 4, 2, 200, 128, True), (3, 8, 4, 129, 32, False),
               (3, 2, 1, 37, 16, True),
               # BERT-Large's tensor=2 and tensor=4 shards: H8, H4.
               (3, 8, 8, 512, 64, False), (3, 4, 4, 512, 64, False)]


def _bias(kind, b, t, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kind == "random":
        return 3.0 * torch.randn((b, t), generator=g, device="cuda")
    lengths = torch.tensor([t, max(1, t // 3)][:b - 1] + [0], device="cuda")
    keys = torch.arange(t, device="cuda")
    return torch.where(keys[None, :] < lengths[:, None], 0.0,
                       -1e30).float()


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.bfloat16, "fma"),
                                         (torch.float32, "fma")])
@pytest.mark.parametrize("kind", ["padding", "random"])
@pytest.mark.parametrize("b,h,hkv,t,d,causal", BIAS_SHAPES)
def test_flash_bias_matches_plain(b, h, hkv, t, d, causal, kind, dtype,
                                  route):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    q = _rand((b, h, t, d), dtype, 40)
    k = _rand((b, hkv, t, d), dtype, 41)
    v = _rand((b, hkv, t, d), dtype, 42)
    do = _rand((b, h, t, d), dtype, 43)
    bias = _bias(kind, b, t, 44)
    before = [(fn.bias_launches, fn.launches_by_route[route])
              for fn in (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
                         fa._flash_bwd_dq_cuda)]
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, bias, route=route)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, causal, bias)
    delta = fa._delta(o, do)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, bias,
                                    route=route)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, bias,
                               route=route)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, causal, bias)
    torch.cuda.synchronize()
    assert [(fn.bias_launches, fn.launches_by_route[route])
            for fn in (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
                       fa._flash_bwd_dq_cuda)] == [
        (n + 1, r + 1) for n, r in before]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    valid = lse_ref > -1e29
    assert torch.equal(lse > -1e29, valid)
    torch.testing.assert_close(lse[valid], lse_ref[valid], rtol=0,
                               atol=1e-3)
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= tol, f"{name}: relative error {err}"
    if kind == "padding":
        for name, x in (("o", o), ("dq", dq), ("dk", dk), ("dv", dv)):
            assert not x[-1].float().any(), f"{name} of the empty sequence"
    again = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, bias,
                                  route=route)
    torch.cuda.synchronize()
    assert torch.equal(dq.view(torch.int16), again.view(torch.int16)) \
        if dtype == torch.bfloat16 else torch.equal(dq, again)


def test_flash_bias_through_the_op_and_autograd():
    """The public flash_attention with a bias on the card: the op takes
    the bias kernels forward and backward (one launch each) and gives the
    bias no gradient."""
    b, t = 2, 130
    q = _rand((b, t, 4, 64), torch.bfloat16, 45).requires_grad_(True)
    k = _rand((b, t, 2, 64), torch.bfloat16, 46).requires_grad_(True)
    v = _rand((b, t, 2, 64), torch.bfloat16, 47).requires_grad_(True)
    bias = _bias("padding", b, t, 48).requires_grad_(True)
    before = [fn.bias_launches for fn in (
        fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda, fa._flash_bwd_dq_cuda)]
    out = fa.flash_attention(q, k, v, causal=False, kv_bias=bias)
    out.float().sum().backward()
    torch.cuda.synchronize()
    assert [fn.bias_launches for fn in (
        fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
        fa._flash_bwd_dq_cuda)] == [n + 1 for n in before]
    assert bias.grad is None
    assert all(torch.isfinite(x.grad.float()).all() for x in (q, k, v))


@pytest.mark.parametrize("d", [48, 256])
def test_flash_bias_on_a_head_dim_no_kernel_takes_raises(d):
    q = _rand((1, 2, 64, d), torch.bfloat16, 49)
    bias = torch.zeros((1, 64), device="cuda")
    lse = torch.zeros((1, 2, 64, 1), device="cuda")
    with pytest.raises(ValueError, match="K1 takes head_dim"):
        fa._flash_fwd_cuda(q, q, q, False, bias)
    with pytest.raises(ValueError, match="K2 takes head_dim"):
        fa._flash_bwd_dkv_cuda(q, q, q, q, lse, lse, False, bias)
    with pytest.raises(ValueError, match="K3 takes head_dim"):
        fa._flash_bwd_dq_cuda(q, q, q, q, lse, lse, False, bias)


# The offsets variant of K1-K3 (one ring-attention step) on both routes
# against the plain versions with the same offsets and a random lse
# cotangent folded into delta: the chunks a ring meets (past, diagonal,
# wholly future: o, dq, dk, dv exactly 0 and a finite lse at or below
# -1e29), offsets that cut tiles anywhere (zero-valid rows inside a tile
# that is not skipped), Tq != Tk, ragged T, each head dim.
OFFSET_SHAPES = [  # b, h, hkv, tq, tk, d, q_offset, kv_offset
    (1, 4, 2, 256, 256, 128, 768, 0), (1, 4, 2, 256, 256, 128, 256, 256),
    (1, 4, 2, 256, 256, 128, 0, 768), (2, 4, 2, 200, 200, 64, 237, 200),
    (1, 4, 1, 256, 128, 128, 256, 64), (1, 2, 2, 77, 300, 16, 100, 37),
    (1, 4, 2, 130, 130, 32, 0, 5)]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.bfloat16, "fma"),
                                         (torch.float32, "fma")])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,tq,tk,d,q_off,kv_off", OFFSET_SHAPES)
def test_flash_offsets_match_plain(b, h, hkv, tq, tk, d, q_off, kv_off,
                                   causal, dtype, route):
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    offsets = (q_off, kv_off)
    q = _rand((b, h, tq, d), dtype, 60)
    k = _rand((b, hkv, tk, d), dtype, 61)
    v = _rand((b, hkv, tk, d), dtype, 62)
    do = _rand((b, h, tq, d), dtype, 63)
    dlse = _rand((b, h, tq, 1), torch.float32, 64)
    wrappers = (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
                fa._flash_bwd_dq_cuda)
    before = [(fn.offsets_launches, fn.launches_by_route[route])
              for fn in wrappers]
    o, lse = fa._flash_fwd_cuda(q, k, v, causal, None, offsets, route=route)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, causal, None, offsets)
    delta = fa._delta(o, do, dlse)
    dk, dv = fa._flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, None,
                                    offsets, route=route)
    dq = fa._flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, None,
                               offsets, route=route)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, causal, None,
                                   offsets, dlse)
    torch.cuda.synchronize()
    assert [(fn.offsets_launches, fn.launches_by_route[route])
            for fn in wrappers] == [(n + 1, r + 1) for n, r in before]
    torch.testing.assert_close(o.float(), o_ref.float(), rtol=0, atol=tol)
    assert torch.isfinite(lse).all()
    valid = lse_ref > -1e29
    assert torch.equal(lse > -1e29, valid)
    torch.testing.assert_close(lse[valid], lse_ref[valid], rtol=0,
                               atol=1e-3)
    future = causal and kv_off > q_off + tq - 1
    for name, g, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if future:
            assert not g.float().any() and not w.float().any(), name
            continue
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        assert err <= tol, f"{name}: relative error {err}"
    if future:
        assert not o.float().any() and (lse <= -1e29).all()


def test_flash_chunk_op_and_ring_replay_on_wgmma():
    """``flash_attention_chunk`` on bf16 CUDA tensors launches the offsets
    kernels on wgmma only (K1 forward, K2 and K3 backward, one each a
    step), and a seq=4 ring replayed through ``ring_flash_steps`` on one
    card matches the one-shot K1-K3 over the whole sequence."""
    from horovod_tpu_torch.parallel.ring_attention import ring_flash_steps

    n, b, h, hkv, t, d = 4, 1, 4, 2, 512, 128
    q = _rand((b, h, t, d), torch.bfloat16, 70)
    k = _rand((b, hkv, t, d), torch.bfloat16, 71)
    v = _rand((b, hkv, t, d), torch.bfloat16, 72)
    do = _rand((b, h, t, d), torch.bfloat16, 73)
    wrappers = (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
                fa._flash_bwd_dq_cuda)
    before = [(fn.offsets_launches, dict(fn.launches_by_route))
              for fn in wrappers]
    tc = t // n
    ks, vs = k.split(tc, 2), v.split(tc, 2)
    parts, grads = [], []
    for idx in range(n):
        qi = q[:, :, idx * tc:(idx + 1) * tc].detach().requires_grad_(True)
        kv = [x.detach().requires_grad_(True) for x in ks + vs]
        at = [idx]

        def rotate(kt, vt, at=at, kv=kv):
            at[0] = (at[0] - 1) % n
            return kv[at[0]], kv[n + at[0]]

        o, _ = ring_flash_steps(qi, kv[idx], kv[n + idx], idx, n, rotate)
        o = o.to(torch.bfloat16)
        g = torch.autograd.grad(o, [qi] + kv,
                                do[:, :, idx * tc:(idx + 1) * tc])
        parts.append(o.detach())
        grads.append(g)
    torch.cuda.synchronize()
    after = [(fn.offsets_launches, fn.launches_by_route)
             for fn in wrappers]
    for (n0, r0), (n1, r1) in zip(before, after):
        assert n1 - n0 == n * n
        assert r1["wgmma"] - r0["wgmma"] == n * n and r1["fma"] == r0["fma"]
    o_full, lse_full = fa._flash_fwd_cuda(q, k, v, True)
    dq_full, dk_full, dv_full = fa._flash_bwd_cuda(q, k, v, o_full,
                                                   lse_full, do, True)
    dk_full, dv_full = fa._sum_kv_heads(dk_full, dv_full, hkv)
    o_ring = torch.cat(parts, 2)
    dq_ring = torch.cat([g[0] for g in grads], 2)
    dk_ring = torch.cat([sum(g[1 + j].float() for g in grads)
                         for j in range(n)], 2)
    dv_ring = torch.cat([sum(g[1 + n + j].float() for g in grads)
                         for j in range(n)], 2)
    for name, got, want in (("o", o_ring, o_full), ("dq", dq_ring, dq_full),
                            ("dk", dk_ring, dk_full),
                            ("dv", dv_ring, dv_full)):
        err = float((got.float() - want.float()).abs().max()
                    / want.float().abs().max())
        assert err <= 3e-2, f"{name}: relative error {err}"


# ---- the lane's wire codecs ----------------------------------------------


def _codec_input(n, seed):
    """Seeded values in [-2, 2] with NaN payloads, infinities, signed
    zeros and denormals planted, and an all-zero and an all-denormal
    record where the length allows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n).astype(np.float32)
    bits = x.view(np.uint32)
    plant = [0x80000000, 0x7F800000, 0xFF800000, 0x7FC00001, 0xFF812345,
             0x00000001, 0x807FFFFF, 0x3F808000, 0x7F7FFFFF]
    for i, b in enumerate(plant[:n // 300]):
        bits[(i * 997) % n] = b
    if n >= 1024:
        x[256:512] = 0.0
        bits[512:768] = rng.integers(1, 1 << 23, 256).astype(np.uint32)
    return torch.from_numpy(x)


def _same(got, want):
    """The same bytes; for a float result the same bits wherever the
    plain version's value is a number, and NaN where it is NaN: the card
    gives arithmetic's NaNs (NaN times a quant, a NaN summed) its
    canonical payload, 0x7FFFFFFF, where the CPU keeps the operand's."""
    got = got.cpu()
    if want.dtype != torch.float32:
        assert torch.equal(got, want)
        return
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@pytest.mark.parametrize("codec", [wc.BF16, wc.INT8])
@pytest.mark.parametrize("count,n", [(1, 1), (255, 1), (257, 1), (4099, 4),
                                     (3, 4), (1 << 20, 8), (5000, 3)])
def test_wire_codec_kernels_match_plain(codec, count, n):
    x = _codec_input(count, count + n)
    seg = wc.Segments.even(count, n)
    img = wc.encode(x.cuda(), codec, seg)
    want = wc.encode(x, codec, seg)
    _same(img, want)
    stride = wc.image_len(seg.largest, codec)
    slots = torch.zeros(n * stride, dtype=torch.uint8)
    pos = 0
    for i in range(n):
        w = wc.image_len(seg.count(i), codec)
        slots[i * stride:i * stride + w] = want[pos:pos + w]
        pos += w
    for post in (1.0, 1.0 / 3.0):
        got = wc.decode_scale(torch.zeros(count, device="cuda"), img, codec,
                              seg, post=post)
        _same(got, wc.decode_scale(torch.zeros(count), want, codec, seg,
                                   post=post))
        got = wc.decode_scale(torch.zeros(count, device="cuda"),
                              slots.cuda(), codec, seg, stride, post)
        _same(got, wc.decode_scale(torch.zeros(count), slots, codec, seg,
                                   stride, post))
    m = seg.count(0)
    images = torch.cat([wc.encode(_codec_input(m, s), codec)
                        for s in range(3)])
    base = _codec_input(m, 99)
    got = wc.decode_accum(base.cuda(), images.cuda(), codec, 3)
    torch.cuda.synchronize()
    _same(got, wc.decode_accum(base.clone(), images, codec, 3))


def test_wire_codec_counts_launches_and_checks_inputs():
    before = dict(wc.launches)
    x = torch.randn(1000, device="cuda")
    img = wc.encode(x, wc.INT8)
    wc.decode_scale(torch.empty_like(x), img, wc.INT8)
    wc.decode_accum(torch.zeros_like(x), img, wc.INT8)
    wc.encode(torch.empty(0, device="cuda"), wc.BF16)    # nothing to do
    torch.cuda.synchronize()
    moved = {k: wc.launches[k] - before[k] for k in wc.KERNELS}
    assert moved == {"encode_bf16": 0, "decode_accum_bf16": 0,
                     "decode_scale_bf16": 0, "encode_int8": 1,
                     "decode_accum_int8": 1, "decode_scale_int8": 1}
    with pytest.raises(ValueError):
        wc.encode(x.half(), wc.BF16)
    with pytest.raises(ValueError):
        wc.decode_scale(x, img[:10], wc.INT8)


# ---- the Adam update -------------------------------------------------------


def _adam_inputs(n, p_dtype, g_dtype, seed, offset):
    """p, g, mu, nu as views at ``offset`` elements into larger buffers
    (offset 0: 16-byte aligned; odd: the scalar path)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def view(dtype, scale, positive=False):
        t = torch.randn(n + offset, generator=gen, device="cuda") * scale
        return (t.abs() if positive else t).to(dtype)[offset:]

    return (view(p_dtype, 1.0), view(g_dtype, 1e-2),
            view(p_dtype, 1e-3), view(p_dtype, 1e-5, positive=True))


def _bits(t):
    return t.contiguous().view(torch.uint8)


@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("n", [1, 7, 8, 4099, 1 << 20])
@pytest.mark.parametrize("variant,p_dtype,g_dtype", [
    ("adam", torch.bfloat16, torch.bfloat16),
    ("adam", torch.float32, torch.float32),
    ("master", torch.float32, torch.bfloat16),
    ("master", torch.float32, torch.float32)])
def test_adam_kernel_matches_plain_bit_for_bit(variant, p_dtype, g_dtype, n,
                                               offset):
    from horovod_tpu_torch.parallel.precision import _bias_corrections

    p, g, mu, nu = _adam_inputs(n, p_dtype, g_dtype, n + offset, offset)
    state = {"kernel": [t.clone() for t in (p, mu, nu)],
             "plain": [t.clone() for t in (p, mu, nu)]}
    casts = {k: torch.empty(n, dtype=g_dtype, device="cuda")
             for k in state} if variant == "master" else None
    count = torch.zeros((), dtype=torch.int32, device="cuda")
    before = adam._adam_cuda.launches_by_variant[variant]
    for _ in range(3):
        count = count + 1
        bc1, bc2 = _bias_corrections(count, 0.9, 0.999)
        for name, fn in (("kernel", adam._adam_cuda),
                         ("plain", adam._adam_plain)):
            tp, tmu, tnu = state[name]
            fn(tp, g, tmu, tnu, 3e-4, 0.9, 0.999, 1e-8, bc1, bc2, None,
               None if casts is None else casts[name])
        torch.cuda.synchronize()
        for a, b in zip(state["kernel"], state["plain"]):
            assert torch.equal(_bits(a), _bits(b))
        if casts is not None:
            assert torch.equal(_bits(casts["kernel"]), _bits(casts["plain"]))
    assert adam._adam_cuda.launches_by_variant[variant] - before == 3


def test_adam_kernel_writes_a_separate_out_and_raises_on_what_it_takes_not():
    from horovod_tpu_torch.parallel.precision import _bias_corrections

    bc1, bc2 = _bias_corrections(torch.ones((), dtype=torch.int32,
                                            device="cuda"), 0.9, 0.999)
    p, g, mu, nu = _adam_inputs(1001, torch.bfloat16, torch.bfloat16, 5, 0)
    p0 = p.clone()
    out, ref = torch.empty_like(p), torch.empty_like(p)
    mu_ref, nu_ref = mu.clone(), nu.clone()
    adam.adam_update(p, g, mu, nu, 1e-3, 0.9, 0.999, 1e-8, bc1, bc2, out=out)
    adam._adam_plain(p0, g, mu_ref, nu_ref, 1e-3, 0.9, 0.999, 1e-8, bc1,
                     bc2, ref, None)
    torch.cuda.synchronize()
    assert torch.equal(p, p0) and torch.equal(_bits(out), _bits(ref))
    assert torch.equal(_bits(mu), _bits(mu_ref))
    with pytest.raises(ValueError):      # mixed dtypes without a master
        adam.adam_update(p, g.float(), mu, nu, 1e-3, 0.9, 0.999, 1e-8, bc1,
                         bc2)
    with pytest.raises(ValueError):      # bias corrections on the host
        adam.adam_update(p, g, mu, nu, 1e-3, 0.9, 0.999, 1e-8, bc1.cpu(),
                         bc2.cpu())
    with pytest.raises(ValueError):      # a master that is not f32
        adam.adam_update(p, g, mu, nu, 1e-3, 0.9, 0.999, 1e-8, bc1, bc2,
                         cast=torch.empty_like(p))
