"""Which kernel each op launches, decided on the host without a card.

K1, K2, K5 and K6 have two kernels each: bf16 runs on the tensor cores
(the wgmma kernels, csrc/flash_fwd_wgmma.cu, csrc/flash_bwd_wgmma.cu and
csrc/grouped_mm_wgmma.cu), f32 on FMA (csrc/flash_fwd.cu,
csrc/flash_bwd.cu and csrc/grouped_mm.cu). The route is a pure function
of the dtype (and, for K1 and K2, the head dim), never a fallback; the
wgmma kernels' width rule, K5's split-K plan, the build's hash and the
kernels' headers are checked here too (tests/test_torch_import.py checks
the source list); tests/test_torch_cuda_kernels.py runs the kernels.
"""

from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.ops import _build
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


@pytest.mark.parametrize("dtype,asked,want", [
    (torch.bfloat16, None, "wgmma"), (torch.float32, None, "fma"),
    (torch.bfloat16, "fma", "fma")])
def test_flash_routes_by_name(dtype, asked, want):
    for kernel, route in (("K1", fa.flash_fwd_route),
                          ("K2", fa.flash_bwd_route)):
        assert fa.pick_route(kernel, dtype, route(dtype, 128),
                             asked) == want


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


def test_wrappers_count_by_route():
    for fn in (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda, gm._gmm_cuda,
               gm._gmm_dlhs_cuda, gm._tgmm_cuda):
        assert set(fn.launches_by_route) == {"wgmma", "fma"}


def test_cpu_tensors_take_the_plain_version_not_a_route():
    """On CPU tensors the ops run their plain versions: no route, no
    launch, whatever the dtype."""
    wrappers = (fa._flash_fwd_cuda, fa._flash_bwd_dkv_cuda, gm._gmm_cuda,
                gm._gmm_dlhs_cuda, gm._tgmm_cuda)
    before = [dict(fn.launches_by_route, all=fn.launches) for fn in wrappers]
    q = torch.randn(1, 2, 5, 16).bfloat16()
    o, lse = fa._flash_fwd_impl(q, q[:, :1], q[:, :1], True)
    fa._flash_bwd_impl(q, q[:, :1], q[:, :1], o, lse, q, True)
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


@pytest.mark.parametrize("source", ["flash_bwd_wgmma", "grouped_mm_wgmma"])
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
