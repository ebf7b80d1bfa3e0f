"""Which kernel each op launches, decided on the host without a card.

K1-K6 have two kernels each: bf16 runs on the tensor cores (the wgmma
kernels, csrc/flash_fwd_wgmma.cu, csrc/flash_bwd_wgmma.cu,
csrc/flash_bwd_dq_wgmma.cu, csrc/decode_attention_wgmma.cu and
csrc/grouped_mm_wgmma.cu), f32 on FMA (csrc/flash_fwd.cu,
csrc/flash_bwd.cu, csrc/decode_attention.cu and csrc/grouped_mm.cu). The
route is a pure function of the dtype (and, for K1-K4, the head dim),
never a fallback; the wgmma kernels' width rule, K5's split-K plan, K4's
cluster plan, the padded residuals K2 and K3 share, the build's hash and
the kernels' headers are checked here too (tests/test_torch_import.py
checks the source list); tests/test_torch_cuda_kernels.py runs the
kernels.
"""

from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.ops import _build
from horovod_tpu_torch.ops import decode_attention as da
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import grouped_moe as gm

CSRC = Path(__file__).resolve().parent.parent / "horovod_tpu_torch" / "csrc"


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_route_bf16_is_wgmma(d):
    assert fa.flash_fwd_route(torch.bfloat16, d) == "wgmma"


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_route_f32_is_fma(d):
    assert fa.flash_fwd_route(torch.float32, d) == "fma"


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 128, "no kernel for torch.float16"),
    (torch.bfloat16, 256, "head_dim"),
    (torch.float32, 48, "head_dim")])
def test_flash_route_raises_for_what_no_kernel_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_fwd_route(dtype, d)


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_bwd_route_by_dtype(d):
    assert fa.flash_bwd_route(torch.bfloat16, d) == "wgmma"
    assert fa.flash_bwd_route(torch.float32, d) == "fma"


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 128, "K2 has no kernel for torch.float16"),
    (torch.bfloat16, 256, "head_dim"),
    (torch.float32, 48, "head_dim")])
def test_flash_bwd_route_raises_for_what_no_kernel_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        fa.flash_bwd_route(dtype, d)


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 128, "K3 has no kernel for torch.float16"),
    (torch.bfloat16, 256, "head_dim"),
    (torch.float32, 48, "head_dim")])
def test_k3_route_raises_naming_k3(dtype, d, match):
    """K3 shares K2's route rule; its errors name K3."""
    with pytest.raises(ValueError, match=match):
        fa.flash_bwd_route(dtype, d, "K3")


@pytest.mark.parametrize("dtype,asked,want", [
    (torch.bfloat16, None, "wgmma"), (torch.float32, None, "fma"),
    (torch.bfloat16, "fma", "fma")])
def test_flash_routes_by_name(dtype, asked, want):
    for kernel, route in (("K1", fa.flash_fwd_route),
                          ("K2", fa.flash_bwd_route),
                          ("K3", fa.flash_bwd_route)):
        assert fa.pick_route(kernel, dtype, route(dtype, 128),
                             asked) == want


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_decode_route_by_dtype(d):
    assert da.decode_route(torch.bfloat16, d) == "wgmma"
    assert da.decode_route(torch.float32, d) == "fma"


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 128, "K4 has no kernel for torch.float16"),
    (torch.bfloat16, 8, "head_dim"),
    (torch.bfloat16, 48, "head_dim")])
def test_decode_route_raises_for_what_no_kernel_takes(dtype, d, match):
    with pytest.raises(ValueError, match=match):
        da.decode_route(dtype, d)


@pytest.mark.parametrize("dtype,asked,want", [
    (torch.bfloat16, None, "wgmma"), (torch.float32, None, "fma"),
    (torch.bfloat16, "fma", "fma")])
def test_decode_routes_by_name(dtype, asked, want):
    assert da.pick_route("K4", dtype, da.decode_route(dtype, 128),
                         asked) == want
    if dtype == torch.float32:
        with pytest.raises(ValueError, match="K4 route 'wgmma' does not"):
            da.pick_route("K4", dtype, da.decode_route(dtype, 128), "wgmma")


@pytest.mark.parametrize("dtype,asked", [(torch.float32, "wgmma"),
                                         (torch.bfloat16, "tensor")])
def test_flash_route_refuses_a_kernel_that_does_not_take_dtype(dtype, asked):
    with pytest.raises(ValueError, match="K2 route .* does not take"):
        fa.pick_route("K2", dtype, fa.flash_bwd_route(dtype, 64), asked)


def test_grouped_route_by_dtype():
    """One route function serves K5 and both halves of K6."""
    assert gm.grouped_route(torch.bfloat16) == "wgmma"
    assert gm.grouped_route(torch.float32) == "fma"
    with pytest.raises(ValueError, match="no kernel for torch.float16"):
        gm.grouped_route(torch.float16)
    assert gm._pick_route("K5 gmm", torch.bfloat16, None) == "wgmma"
    assert gm._pick_route("K5 gmm", torch.float32, None) == "fma"


@pytest.mark.parametrize("dtype,asked,want", [
    (torch.bfloat16, None, "wgmma"), (torch.float32, None, "fma"),
    (torch.bfloat16, "fma", "fma"), (torch.bfloat16, "wgmma", "wgmma")])
def test_grouped_route_by_name(dtype, asked, want):
    assert gm._pick_route("K6 dlhs", dtype, asked) == want


@pytest.mark.parametrize("dtype,asked", [(torch.float32, "wgmma"),
                                         (torch.bfloat16, "tensor")])
def test_grouped_route_refuses_a_kernel_that_does_not_take_dtype(dtype,
                                                                 asked):
    with pytest.raises(ValueError, match="does not take"):
        gm._pick_route("K6 tgmm", dtype, asked)


def test_wgmma_widths_must_be_multiples_of_8():
    gm._check_wgmma_widths("K6 dlhs", K=2048, N=4096)
    with pytest.raises(ValueError, match=r"K and N to be multiples of 8.*"
                                         r"'K': 130"):
        gm._check_wgmma_widths("K6 dlhs", K=130, N=4096)


@pytest.mark.parametrize("k,n,bad", [(2048, 4100, "'N': 4100"),
                                     (2050, 4096, "'K': 2050")])
def test_k5_wgmma_widths_must_be_multiples_of_8(k, n, bad):
    gm._check_wgmma_widths("K5 gmm", K=2048, N=2048)
    with pytest.raises(ValueError, match=rf"K5 gmm .*{bad}"):
        gm._check_wgmma_widths("K5 gmm", K=k, N=n)


# (M, K, N): the MoE model's train microbatch (B2 T2048 top-2 = 8192
# routed rows) and b16 x 128 prefill (4096 rows), gate/up (K2048 N4096)
# and down (K4096 N2048), E = 4, on an H100's 132 SMs.
BIG_M = [(8192, 2048, 4096), (8192, 4096, 2048), (4096, 2048, 4096),
         (4096, 4096, 2048)]
# A b16 decode step (32 routed rows) and the engine's max_batch 8 step.
SMALL_M = [(32, 2048, 4096), (32, 4096, 2048), (16, 2048, 4096),
           (16, 4096, 2048)]


@pytest.mark.parametrize("m,k,n", BIG_M)
def test_split_k_is_one_at_train_and_prefill_shapes(m, k, n):
    assert gm._gmm_split_k(m, k, n, 4, 132) == 1


@pytest.mark.parametrize("m,k,n", SMALL_M)
def test_split_k_splits_at_decode_shapes(m, k, n):
    """Decode's grid (4 visits x 32 or 16 N tiles) leaves SMs idle: the
    contraction is split, into ranges that fill whole waves."""
    blocks = (-(-m // 128) + 3) * (n // 128)
    assert blocks < 132
    s = gm._gmm_split_k(m, k, n, 4, 132)
    assert 1 < s <= 8
    assert s == 2  # 256 blocks (gate/up) or 128 (down): no wave half-full


@pytest.mark.parametrize("k", [64, 100, 128, 320, 2048, 2056, 4096])
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
def test_split_k_ranges_are_aligned_and_cover_k(k, splits):
    ranges = gm._split_k_ranges(k, splits)
    assert 1 <= len(ranges) <= splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (a, b), (c, _) in zip(ranges, ranges[1:]):
        assert b == c
    assert all(a % 64 == 0 and a < b for a, b in ranges)
    widths = {b - a for a, b in ranges[:-1]}
    assert len(widths) <= 1 and all(w % 64 == 0 for w in widths)


@pytest.mark.parametrize("m", [1, 16, 32, 63, 64, 65, 127, 129, 300])
@pytest.mark.parametrize("k,n", [(2048, 4096), (4096, 2048), (72, 136),
                                 (640, 256)])
def test_split_k_plan_depends_on_shapes_only(m, k, n):
    """The plan is a pure function of (M, K, N, E, SMs), and its ranges
    are exactly as many as it names: the workspace the wrapper sizes from
    them matches the grid the kernel launches."""
    s = gm._gmm_split_k(m, k, n, 4, 132)
    assert s == gm._gmm_split_k(m, k, n, 4, 132)
    assert len(gm._split_k_ranges(k, s)) == s
    if (-(-m // 128) + 3) * -(-n // 128) >= 132:
        assert s == 1


WRAPPERS = (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
            fa._flash_bwd_dq_cuda, da._decode_attention_cuda, gm._gmm_cuda,
            gm._gmm_dlhs_cuda, gm._tgmm_cuda)


def test_wrappers_count_by_route():
    for fn in WRAPPERS:
        assert set(fn.launches_by_route) == {"wgmma", "fma"}
        assert fn.launches == 0 or fn.launches == sum(
            fn.launches_by_route.values())


def test_cpu_tensors_take_the_plain_version_not_a_route():
    """On CPU tensors the ops run their plain versions: no route, no
    launch, whatever the dtype."""
    wrappers = WRAPPERS
    before = [dict(fn.launches_by_route, all=fn.launches) for fn in wrappers]
    q = torch.randn(1, 2, 5, 16).bfloat16()
    o, lse = fa._flash_fwd_impl(q, q[:, :1], q[:, :1], True)
    fa._flash_bwd_impl(q, q[:, :1], q[:, :1], o, lse, q, True)
    da.decode_attention(q[:, :, :1].transpose(1, 2).contiguous(),
                        q[:, :1], q[:, :1], 3)
    lhs, rhs = torch.randn(6, 8).bfloat16(), torch.randn(2, 8, 16).bfloat16()
    gs = torch.tensor([2, 4], dtype=torch.int32)
    gm._gmm_impl(lhs, rhs, gs)
    gm._gmm_backward_impl(lhs, rhs, gs, torch.randn(6, 16).bfloat16())
    assert [dict(fn.launches_by_route, all=fn.launches)
            for fn in wrappers] == before


def test_build_hash_covers_the_hopper_header(tmp_path, monkeypatch):
    """An edit of hopper.cuh (or any header) rebuilds every library."""
    for f in CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    with open(tmp_path / "hopper.cuh", "a") as f:
        f.write("\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert all(before[n] != after[n] for n in _build.SOURCES)


def test_kernel_sources_include_no_framework_headers():
    """The libraries are plain C interfaces built in seconds: no PyTorch,
    CUTLASS or CuTe headers, and only the toolkit's and csrc's own."""
    allowed = {"stdint.h", "cuda.h", "cuda_bf16.h", "cuda_runtime.h",
               "common.cuh", "hopper.cuh"}
    for path in sorted(CSRC.glob("*.cu*")):
        for line in path.read_text().splitlines():
            if line.startswith("#include"):
                header = line.split()[1].strip('<>"')
                assert header in allowed, f"{path.name} includes {header}"


@pytest.mark.parametrize("source", ["flash_bwd_wgmma", "flash_bwd_dq_wgmma",
                                    "decode_attention_wgmma",
                                    "grouped_mm_wgmma"])
def test_build_hash_covers_each_wgmma_source(tmp_path, monkeypatch, source):
    """An edit of one kernel source rebuilds that library alone."""
    for f in CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    before = {n: _build._library_path(n) for n in _build.SOURCES}
    with open(tmp_path / f"{source}.cu", "a") as f:
        f.write("\n")
    after = {n: _build._library_path(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == {source}


@pytest.mark.parametrize("source", sorted(
    p.stem for p in CSRC.glob("*_wgmma.cu")))
def test_wgmma_sources_build_on_the_hopper_header(source):
    """Every wgmma kernel takes its PTX helpers (the narrow products and
    the cluster helpers included) from hopper.cuh, whose every edit
    rebuilds it (test_build_hash_covers_the_hopper_header)."""
    text = (CSRC / f"{source}.cu").read_text()
    assert '#include "hopper.cuh"' in text
    assert source in _build.SOURCES


def test_hopper_header_has_the_k4_helpers():
    text = (CSRC / "hopper.cuh").read_text()
    for helper in ("wgmma_m64n8k16_ss", "wgmma_m64n16k16_ss", "cluster_rank",
                   "cluster_sync", "ld_cluster_f32", "mapa.shared::cluster",
                   "barrier.cluster.arrive", "ld.shared::cluster"):
        assert helper in text, helper


# An H100 SXM: 132 SMs, and how many clusters of 1, 2, 4, 8 and 16 K4
# blocks it holds at once (cudaOccupancyMaxActiveClusters on the card).
H100 = (132, (132, 66, 30, 15, 7))


@pytest.mark.parametrize("b,hkv,n_rep,n_valid,want", [
    (16, 4, 4, 151, (2, 2, False)),     # dense decode step, S192
    (16, 4, 4, 192, (2, 2, False)),
    (16, 8, 2, 151, (1, 3, False)),     # MoE decode step: 128 blocks
    (16, 4, 4, 1, (1, 1, False)),       # pos 0: one tile
    (1, 4, 4, 32768, (16, 32, False)),  # long cache: 16-block clusters
    (1, 1, 16, 40000, (16, 40, True)),  # n_rep 16: the scores spill
    (2, 1, 16, 129, (2, 2, False))])
def test_decode_plan_at_the_main_path_shapes(b, hkv, n_rep, n_valid, want):
    assert da._decode_plan(b * hkv, n_rep, n_valid, *H100) == want


@pytest.mark.parametrize("pairs", [1, 3, 4, 16, 64, 128, 132, 300])
@pytest.mark.parametrize("n_valid", [1, 63, 64, 65, 151, 1000, 4100, 32768,
                                     40000])
@pytest.mark.parametrize("n_rep", [1, 4, 16])
def test_decode_plan_covers_the_cache_in_one_wave(pairs, n_valid, n_rep):
    """The plan is a pure function of shapes and the card: its C * tpb
    tiles cover n_valid with the fewest tiles a block (the last ranks may
    get none: the kernel takes an empty slice), one cluster per (batch,
    kv head) fits the card at once whenever C > 1, and the scores spill
    exactly when they outgrow shared memory."""
    c, tpb, spill = da._decode_plan(pairs, n_rep, n_valid, *H100)
    tiles = -(-n_valid // 64)
    assert (c, tpb, spill) == da._decode_plan(pairs, n_rep, n_valid, *H100)
    assert c in (1, 2, 4, 8, 16) and c <= tiles
    assert c * tpb >= tiles > c * (tpb - 1)
    if c > 1:
        assert pairs * c <= H100[0]
        assert pairs <= H100[1][c.bit_length() - 1]
    assert spill == (n_rep * tpb * 64 > 8192)


def test_k2_and_k3_share_padded_residuals():
    """On the wgmma route lse and delta are padded to 64 queries with
    zeros (each tile one 256-byte copy); a pair padded once by
    _flash_bwd_cuda passes through as is; the FMA route takes them as
    given."""
    q = torch.zeros(2, 3, 70, 16)
    lse, delta = torch.randn(2, 3, 70, 1), torch.randn(2, 3, 70, 1)
    pl, pd = fa._residuals("wgmma", q, lse, delta, None)
    assert pl.shape == pd.shape == (6, 128)
    assert torch.equal(pl[:, :70], lse.reshape(6, 70))
    assert not pl[:, 70:].any() and not pd[:, 70:].any()
    assert fa._residuals("wgmma", q, lse, delta, (pl, pd)) == (pl, pd)
    assert fa._residuals("fma", q, lse, delta, (pl, pd)) == (lse, delta)


# The bias variant of K1-K3, decided on the host: each wrapper passes the
# bias (or a null pointer) in the slot after v, pads it to 128 keys for
# the wgmma kernels only, and counts bias launches apart. The launch
# itself is recorded instead of made (no card here);
# tests/test_torch_cuda_kernels.py runs it.


@pytest.fixture
def recorded(monkeypatch):
    """Record each K1-K3 launch as (entry, pointer count, tensors)."""
    launches = []
    monkeypatch.setattr(fa, "_check_kernel_inputs", lambda *a: None)
    monkeypatch.setattr(fa, "_bind", lambda source, name, n: (name, n))
    monkeypatch.setattr(fa, "_launch", lambda label, fn, tensors, *a:
                        launches.append((fn[0], fn[1], tensors)))
    for fn in (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
               fa._flash_bwd_dq_cuda):
        monkeypatch.setattr(fn, "launches", 0)
        monkeypatch.setattr(fn, "bias_launches", 0)
        monkeypatch.setattr(fn, "launches_by_route", {"wgmma": 0, "fma": 0})
    return launches


def _bias_inputs(d=64, t=512, dtype=torch.bfloat16):
    q = torch.zeros(2, 4, t, d, dtype=dtype)
    kv = torch.zeros(2, 4, t, d, dtype=dtype)
    res = torch.zeros(2, 4, t, 1)
    return q, kv, res


def _call_all(q, kv, res, kv_bias, route=None):
    fa._flash_fwd_cuda(q, kv, kv, False, kv_bias, route=route)
    fa._flash_bwd_dkv_cuda(q, kv, kv, q, res, res, False, kv_bias,
                           route=route)
    fa._flash_bwd_dq_cuda(q, kv, kv, q, res, res, False, kv_bias,
                          route=route)


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "fma")])
def test_null_bias_keeps_the_old_launches(recorded, dtype, route):
    """Without a bias each wrapper makes its one launch, with a null
    pointer in the bias slot, and no bias launch is counted."""
    q, kv, res = _bias_inputs(dtype=dtype)
    _call_all(q, kv, res, None)
    assert [(name, n) for name, n, _ in recorded] == [
        fa._FWD_ENTRY[route][1:] + (6,), fa._DKV_ENTRY[route][1:] + (9,),
        fa._DQ_ENTRY[route][1:] + (8,)]
    assert all(tensors[3] is None for _, _, tensors in recorded)
    for fn in (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
               fa._flash_bwd_dq_cuda):
        assert (fn.launches, fn.bias_launches) == (1, 0)
        assert fn.launches_by_route[route] == 1


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "fma"),
                                         (torch.bfloat16, "fma")])
@pytest.mark.parametrize("t", [512, 77])
def test_bias_rides_in_the_slot_after_v(recorded, dtype, route, t):
    """The bias goes to every kernel: as given to the FMA kernels; padded
    with zeros to a multiple of 128 keys for wgmma (no copy when T is
    one already)."""
    q, kv, res = _bias_inputs(t=t, dtype=dtype)
    bias = torch.randn(2, t)
    _call_all(q, kv, res, bias, route=route)
    for _, _, tensors in recorded:
        got = tensors[3]
        if route == "fma" or t % 128 == 0:
            assert got is bias
        else:
            assert got.shape == (2, 128) and torch.equal(got[:, :t], bias)
            assert not got[:, t:].any()
    for fn in (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda,
               fa._flash_bwd_dq_cuda):
        assert (fn.launches, fn.bias_launches) == (1, 1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [48, 256])
def test_bias_on_a_head_dim_no_kernel_takes_raises(recorded, dtype, d):
    q, kv, res = _bias_inputs(d=d, t=64, dtype=dtype)
    bias = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="K1 takes head_dim"):
        fa._flash_fwd_cuda(q, kv, kv, False, bias)
    with pytest.raises(ValueError, match="K2 takes head_dim"):
        fa._flash_bwd_dkv_cuda(q, kv, kv, q, res, res, False, bias)
    with pytest.raises(ValueError, match="K3 takes head_dim"):
        fa._flash_bwd_dq_cuda(q, kv, kv, q, res, res, False, bias)
    assert recorded == []


@pytest.mark.parametrize("bad,match", [
    (lambda b: b.double(), "f32"), (lambda b: b[:, :-1], r"\(2, 64\)"),
    (lambda b: b.t().contiguous().t(), "contiguous"),
    (lambda b: b[:1], r"\(2, 64\)")])
def test_bias_must_be_contiguous_f32_b_by_tk(recorded, bad, match):
    q, kv, res = _bias_inputs(t=64)
    bias = bad(torch.zeros(2, 64))
    with pytest.raises(ValueError, match=match):
        fa._flash_fwd_cuda(q, kv, kv, False, bias)
    with pytest.raises(ValueError, match=match):
        fa._flash_bwd_dq_cuda(q, kv, kv, q, res, res, False, bias)
    assert recorded == []


def test_pad_bias_rounds_keys_up_to_128_for_wgmma_only():
    assert fa._pad_bias(None) is None
    b = torch.randn(3, 256)
    assert fa._pad_bias(b) is b
    ragged = torch.ones(3, 129)
    p = fa._pad_bias(ragged)
    assert p.shape == (3, 256) and p[:, :129].eq(1).all()
    assert not p[:, 129:].any()
    assert fa._pad_bias(ragged, "fma") is ragged
