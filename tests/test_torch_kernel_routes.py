"""Which kernel each op launches, decided on the host without a card.

K1 and K6 have two kernels each: bf16 runs on the tensor cores (the
wgmma kernels, csrc/flash_fwd_wgmma.cu and csrc/grouped_mm_wgmma.cu), f32
on FMA (csrc/flash_fwd.cu and csrc/grouped_mm.cu). The route is a pure
function of the dtype (and, for K1, the head dim), never a fallback; the
wgmma kernels' width rule, the build's hash and the kernels' headers are
checked here too (tests/test_torch_import.py checks the source list);
tests/test_torch_cuda_kernels.py runs the kernels.
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


def test_grouped_route_by_dtype():
    assert gm.grouped_bwd_route(torch.bfloat16) == "wgmma"
    assert gm.grouped_bwd_route(torch.float32) == "fma"
    with pytest.raises(ValueError, match="no kernel for torch.float16"):
        gm.grouped_bwd_route(torch.float16)


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


def test_wrappers_count_by_route():
    for fn in (fa._flash_fwd_cuda, gm._gmm_dlhs_cuda, gm._tgmm_cuda):
        assert set(fn.launches_by_route) == {"wgmma", "fma"}


def test_cpu_tensors_take_the_plain_version_not_a_route():
    """On CPU tensors the ops run their plain versions: no route, no
    launch, whatever the dtype."""
    before = (fa._flash_fwd_cuda.launches, gm._gmm_dlhs_cuda.launches,
              gm._tgmm_cuda.launches)
    q = torch.randn(1, 2, 5, 16).bfloat16()
    fa._flash_fwd_impl(q, q[:, :1], q[:, :1], True)
    lhs, rhs = torch.randn(6, 8).bfloat16(), torch.randn(2, 8, 16).bfloat16()
    gs = torch.tensor([2, 4], dtype=torch.int32)
    gm._gmm_backward_impl(lhs, rhs, gs, torch.randn(6, 16).bfloat16())
    assert (fa._flash_fwd_cuda.launches, gm._gmm_dlhs_cuda.launches,
            gm._tgmm_cuda.launches) == before


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
