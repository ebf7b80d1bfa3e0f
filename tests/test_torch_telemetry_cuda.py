"""The FLOP count and the overlap ledger on the card.

Runs only where CUDA is available (``cuda_sm90`` marker, as the kernel
tests); elsewhere every test skips. The custom ops' FLOP formulas
count their kernels' launches on the card (K1, K2 + K3 with the bias
and the offsets, K5 and K6's halves) as the same ops count on the CPU's
plain route, so ``flops_per_step`` does not depend on the route; the
split step of a 2-layer bf16 Llama (its K1-K3 and Adam kernels) counts
on the card what it counts on the CPU; a lane at world size 1 on NCCL
puts its CUDA spans on the host clock through the step marks' anchors
(exposed + hidden == total, total + unattributed == the ``wire_us``
sum).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda_sm90


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    from horovod_tpu_torch.ops import _build

    _build.build_all()
    return torch.device("cuda", 0)


def _both(fn, card, *tensors, **kw):
    """``fn``'s FLOP count on the card and on the CPU, same inputs."""
    from horovod_tpu_torch.telemetry.step_timer import count_flops

    counts = []
    for dev in (card, "cpu"):
        args = [t.to(dev) if torch.is_tensor(t) else t for t in tensors]
        counts.append(count_flops(fn, *args, **kw)[1])
        torch.cuda.synchronize()
    return counts


@pytest.mark.parametrize("variant", ["plain", "bias", "offsets"])
def test_flash_counts_the_same_on_both_routes(card, variant):
    from horovod_tpu_torch.ops import flash_attention as fa

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 256, 128, generator=g).bfloat16()
    k = torch.randn(2, 4, 256, 128, generator=g).bfloat16()
    v = torch.randn(2, 4, 256, 128, generator=g).bfloat16()
    bias = torch.zeros(2, 256) if variant == "bias" else None

    def grad_call(q, k, v, bias=None):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        if variant == "offsets":
            out = fa.flash_attention_chunk(*leaves, 256, 0)[0]
        else:
            out = fa.flash_fwd(*leaves, True, bias)[0]
        out.float().sum().backward()

    launched = fa._flash_bwd_dq_cuda.launches
    on_card, on_cpu = _both(grad_call, card, q, k, v, bias)
    assert fa._flash_bwd_dq_cuda.launches == launched + 1
    assert on_card == on_cpu == 14 * 2 * 16 * 256 * 256 * 128


def test_grouped_counts_the_same_on_both_routes(card):
    from horovod_tpu_torch.ops import grouped_moe as gm

    g = torch.Generator().manual_seed(1)
    lhs = torch.randn(512, 256, generator=g).bfloat16()
    rhs = torch.randn(4, 256, 384, generator=g).bfloat16()
    sizes = torch.tensor([100, 0, 300, 112], dtype=torch.int32)

    def grad_call(lhs, rhs, sizes):
        a = lhs.clone().requires_grad_(True)
        b = rhs.clone().requires_grad_(True)
        gm._grouped_mm(a, b, sizes, "moe_gate_act").float().sum().backward()

    before = gm._tgmm_cuda.launches
    on_card, on_cpu = _both(grad_call, card, lhs, rhs, sizes)
    assert gm._tgmm_cuda.launches == before + 1
    assert on_card == on_cpu == 3 * 2 * 512 * 256 * 384


def test_split_step_counts_the_same_on_both_routes(card):
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.telemetry import StepTimer

    cfg = llama.LlamaConfig(vocab_size=1024, d_model=512, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=1024,
                            dtype="bfloat16", param_dtype="bfloat16",
                            remat="attn+gate")
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 1024, (2, 256))
                              .astype(np.int32))
    flops = []
    for dev in (card, torch.device("cpu")):
        timer = StepTimer()
        ts = train_step.make_split_train_step(
            lambda p, d, dev=dev: llama.llama_loss(p, d, cfg, device=dev),
            precision.fused_adam(1e-3), telemetry=timer)
        carry = ts.init(llama.llama_init(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev))
        data = {"tokens": tokens.to(dev),
                "targets": torch.roll(tokens, -1, 1).to(dev)}
        for _ in range(2):
            loss, carry = ts.step(carry, data)
        assert timer.steps == 2 and bool(torch.isfinite(loss))
        flops.append(timer.flops_per_step)
    assert flops[0] == flops[1] > 0


def test_cuda_spans_reconcile_on_the_ledger(card, monkeypatch):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch import telemetry

    monkeypatch.setenv("HOROVOD_RANK", "0")
    monkeypatch.setenv("HOROVOD_SIZE", "1")
    hvd.init()
    try:
        x = torch.ones(1 << 20, device=card)
        timer = telemetry.StepTimer()
        snap0 = telemetry.snapshot()
        for i in range(3):
            with timer.step():
                timer.set_outputs(hvd.allreduce(x, name=f"span.{i}",
                                                op=hvd.Sum))
        torch.cuda.synchronize()
        snap1 = telemetry.snapshot()
    finally:
        hvd.shutdown()
    ov0, ov1 = snap0["wire"]["overlap"], snap1["wire"]["overlap"]
    spans = sum(ov1[p]["total_us"] - ov0[p]["total_us"]
                for p in ("intra", "cross"))
    spans += ov1["unattributed_us"] - ov0["unattributed_us"]
    assert spans == snap1["wire_us"]["sum_us"] - snap0["wire_us"]["sum_us"]
    for p in ("intra", "cross"):
        assert ov1[p]["exposed_us"] + ov1[p]["hidden_us"] == \
            ov1[p]["total_us"]
    assert len(timer.overlap_per_step) == 3
    assert ov1["steps"] - ov0["steps"] == 3
