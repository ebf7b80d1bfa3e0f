"""The port's step accounting against the JAX package's: StepTimer,
the FLOP count of the split step, step windows, bubbles, predictors,
the overlap ledger and the black-box header.

- **StepTimer** math on known FLOPs and on the same snapshot sequences
  as ``tests/single/test_telemetry.py``, held to JAX's timer; the split
  step under ``telemetry=`` (plain and both ``zero=`` layouts) runs,
  counts and gives the losses of the step without it, bit for bit.
- **FLOP formulas**: each custom op's registered formula (flash forward
  and backward, with and without the bias and the offsets; gmm,
  gmm_unpermute, dlhs, tgmm; qkv_rope, named_matmul) counts, on the same
  inputs, exactly what the FLOP counter (``step_timer.count_flops``, over
  ``torch.utils.flop_counter``'s formulas) counts of its plain version,
  so the card's route counts what the CPU's does. A 2-layer Llama's
  ``flops_per_step`` is the analytic matmul count of its gradient call
  and recompute, exactly; beside JAX's ``cost_analysis()`` of its grad
  program (XLA counts elementwise work too, and its own way) within a
  stated factor.
- **Windows**: the window-owner regressions of
  ``tests/single/test_telemetry.py:527, :576`` replayed on the port.
- **Bubbles**, **predictors**, the Prometheus overlap series: equal to
  JAX's on the same inputs.
- **The overlap ledger** against the offline twin of its math
  (``critpath``'s interval union and intersection), and **the black-box
  header** against the fields ``csrc/operations.cc DumpBlackBox``
  writes.
"""

import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu import telemetry as jtel
from horovod_tpu.telemetry import core as jcore
from horovod_tpu.telemetry import predict as jpredict
from horovod_tpu_torch import telemetry as ttel
from horovod_tpu_torch.common import events, metrics
from horovod_tpu_torch.models import llama as tl
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import grouped_moe as gm
from horovod_tpu_torch.parallel import fusion, precision, train_step
from horovod_tpu_torch.parallel import zero as Z
from horovod_tpu_torch.telemetry import core as tcore
from horovod_tpu_torch.telemetry import predict as tpredict
from horovod_tpu_torch.telemetry.step_timer import count_flops
from horovod_tpu_torch.torch import fused_optimizer as tfo

REPO = pathlib.Path(__file__).resolve().parents[1]


# ---- StepTimer math ----------------------------------------------------


def _plane_snaps():
    """``test_step_timer_per_plane_wire_split``'s snapshots."""
    snaps = []
    for i in range(6):
        snaps.append({
            "initialized": True, "rank": 0, "size": 2, "ops": {},
            "device_ops": {}, "cache": {"hit_rate": 0.0},
            "cycle": {"stalls": 0},
            "wire": {"tx_bytes": 1200 * i, "rx_bytes": 1200 * i,
                     "tx_logical_bytes": 1600 * i,
                     "rx_logical_bytes": 1600 * i,
                     "cross_tx_bytes": 200 * i, "cross_rx_bytes": 200 * i,
                     "cross_tx_logical_bytes": 400 * i,
                     "cross_rx_logical_bytes": 400 * i}})
    return snaps + snaps[-1:] * 4


def _overlap_snaps():
    """``test_step_timer_overlap_summary``'s snapshot."""
    return [{
        "initialized": True, "rank": 0, "size": 2,
        "ops": {"allreduce": {"bytes": 64 * i}}, "device_ops": {},
        "cache": {"hit_rate": 0.25}, "cycle": {"stalls": 1},
        "wire": {"tx_bytes": 0, "tx_logical_bytes": 0,
                 "cross_tx_bytes": 0, "cross_tx_logical_bytes": 0,
                 "overlap": {"steps": 1,
                             "intra": {"last_exposed_us": 4000,
                                       "last_hidden_us": 6000,
                                       "last_total_us": 10000},
                             "cross": {"last_exposed_us": 1000 * i,
                                       "last_hidden_us": 1000,
                                       "last_total_us": 1000 * i + 1000}}}}
        for i in range(8)]


def _timer_rows(core, tel, monkeypatch, snaps):
    it = iter(snaps)
    monkeypatch.setattr(core, "snapshot", lambda: next(it))

    def fake_mark(begin=True, owner=None):
        core._window_owner = owner if begin else None
        return 1

    monkeypatch.setattr(core, "step_mark", fake_mark)
    timer = tel.StepTimer(flops_per_step=2e9, peak_flops=1e12, block=False,
                          predicted_bytes_per_step=64.0)
    for _ in range(3):
        timer.start_step()
        timer.end_step()
    timer.step_times = [0.5, 0.004, 0.002]
    return {"summary": timer.summary(),
            "planes": timer.plane_wire_summary(skip_first=False),
            "overlap": timer.overlap_summary(skip_first=False),
            "ratio": timer.wire_compression_ratio(skip_first=False),
            "goodput": timer.wire_goodput_gbps(skip_first=False)}


@pytest.mark.parametrize("snaps", ["planes", "overlap"])
def test_step_timer_rows_match_jax(monkeypatch, snaps):
    make = {"planes": _plane_snaps, "overlap": _overlap_snaps}[snaps]
    want = _timer_rows(jcore, jtel, monkeypatch, make())
    got = _timer_rows(tcore, ttel, monkeypatch, make())
    assert got == want
    assert got["summary"]["mfu"] == pytest.approx(2e9 / 0.003 / 1e12)


def test_step_timer_peak_and_ewma(monkeypatch):
    from horovod_tpu_torch.telemetry import step_timer

    timer = ttel.StepTimer(flops_per_step=2e9)
    timer.step_times = [0.5, 0.004, 0.004]
    assert timer.mfu() == pytest.approx(0.5)   # the CPU's 1e12
    assert step_timer.device_peak_flops("cpu") == 1e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert step_timer.device_peak_flops("cuda:0") == 989e12
    monkeypatch.setattr(step_timer, "_step_ewma_ms", 0.0)
    for ms in (10.0, 20.0, 20.0):
        step_timer._update_step_ewma(ms)
    assert step_timer.step_time_ewma_ms() == pytest.approx(
        0.9 * (0.9 * 10 + 0.1 * 20) + 0.1 * 20)


# ---- FLOP formulas against the plain versions -------------------------


def _counted(fn, *args):
    return count_flops(fn, *args)[1]


def _qkvd(b=2, h=4, hkv=2, tq=24, tk=24, d=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, h, tq, d, generator=g)
    k = torch.randn(b, hkv, tk, d, generator=g)
    v = torch.randn(b, hkv, tk, d, generator=g)
    return q, k, v


@pytest.mark.parametrize("variant", ["plain", "noncausal", "bias",
                                     "offsets", "offsets_dlse"])
def test_flash_formulas_count_the_plain_matmuls(variant):
    tq = 16 if variant.startswith("offsets") else 24
    q, k, v = _qkvd(tq=tq)
    causal = variant != "noncausal"
    bias = torch.zeros(2, 24) if variant == "bias" else None
    offsets = (37, 8) if variant.startswith("offsets") else None
    if offsets:
        fwd = _counted(fa.flash_chunk, q, k, v, *offsets, causal)
    else:
        fwd = _counted(fa.flash_fwd, q, k, v, causal, bias)
    assert fwd == _counted(fa._flash_fwd_reference, q, k, v, causal, bias,
                           offsets) > 0
    o, lse = fa._flash_fwd_reference(q, k, v, causal, bias, offsets)
    do = torch.randn_like(o)
    dlse = torch.randn_like(lse) if variant == "offsets_dlse" else None
    bwd = _counted(fa.flash_bwd, q, k, v, o, lse, do, causal, bias,
                   list(offsets) if offsets else None, dlse)
    assert bwd == _counted(fa._flash_bwd_reference, q, k, v, o, lse, do,
                           causal, bias, offsets, dlse) > 0
    # Through autograd: the forward op and its backward op, nothing else.
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]

    def grad_call():
        if offsets:
            out = fa.flash_attention_chunk(*leaves, *offsets, causal)[0]
        else:
            out, _ = fa.flash_fwd(*leaves, causal, bias)
        out.sum().backward()

    assert _counted(grad_call) == fwd + bwd


@pytest.mark.parametrize("op", ["gmm", "gmm_unpermute", "dlhs", "tgmm"])
def test_grouped_formulas_count_the_plain_matmuls(op):
    g = torch.Generator().manual_seed(1)
    m, k, n = 40, 16, 24
    sizes = torch.tensor([9, 0, 25, 6], dtype=torch.int32)  # covers M
    lhs = torch.randn(m, k, generator=g)
    rhs = torch.randn(4, k, n, generator=g)
    grad = torch.randn(m, n, generator=g)
    perm = torch.randperm(m, generator=g)
    if op == "gmm":
        got = _counted(gm._grouped_mm, lhs, rhs, sizes, "moe_gate_act")
        want = _counted(gm._gmm_reference, lhs, rhs, sizes)
    elif op == "gmm_unpermute":
        got = _counted(gm._gmm_unpermute, lhs, rhs, sizes, perm)
        want = _counted(gm._gmm_reference, lhs, rhs, sizes)
    elif op == "dlhs":
        got = _counted(gm._gmm_dlhs, grad, rhs, sizes)
        want = _counted(gm._gmm_dlhs_reference, grad, rhs, sizes)
    else:
        got = _counted(gm._tgmm, lhs, grad, sizes)
        want = _counted(gm._tgmm_reference, lhs, grad, sizes)
    assert got == want == 2 * m * k * n


@pytest.mark.parametrize("op", ["qkv_rope", "named_matmul"])
def test_llama_op_formulas_count_the_plain_matmuls(op):
    g = torch.Generator().manual_seed(2)
    h = torch.randn(2, 8, 32, generator=g)
    if op == "qkv_rope":
        ws = [torch.randn(32, n, generator=g) for n in (64, 32, 32)]
        pos = torch.arange(8).expand(2, 8)
        got = _counted(tl.qkv_rope, h, *ws, pos, 10000.0, 16)

        def plain():
            return [torch.matmul(h, w) for w in ws]
        want = _counted(plain)
    else:
        w = torch.randn(32, 48, generator=g)
        got = _counted(tl.named_matmul, h, w, "ffn_gate")
        want = _counted(torch.matmul, h, w)
    assert got == want > 0


# ---- the split step under telemetry= ------------------------------------

B, T = 2, 16


def _llama(remat, dtype="float32"):
    cfg = tl.LlamaConfig.tiny(dtype=dtype, param_dtype="float32",
                              remat=remat)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + 1))
                           .astype(np.int32))
    batch = {"tokens": tok[:, :-1].contiguous(),
             "targets": tok[:, 1:].contiguous()}
    return cfg, batch


def _analytic_flops(cfg, remat):
    """Matmul FLOPs of one gradient call of the tiny Llama: each linear
    layer three times (forward, input and weight gradients), attention
    4 + 10 B H T^2 hd, and the recompute. torch's checkpoint stops its
    replay at the last tensor the backward needs, so ``full`` re-runs a
    layer but its down projection, and ``attn+gate`` (attention and the
    gate saved) the qkv, output and up projections."""
    d, h, hkv, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff,
                       cfg.vocab_size)
    hd, bt = d // h, B * T
    qkv = 2 * bt * d * (h + 2 * hkv) * hd
    wo = 2 * bt * h * hd * d
    ffn = 2 * bt * d * f      # each of gate, up, down
    att_f, att_b = 4 * B * h * T * T * hd, 10 * B * h * T * T * hd
    layer = 3 * (qkv + wo + 3 * ffn) + att_f + att_b
    recompute = {"none": 0, "full": qkv + wo + 2 * ffn + att_f,
                 "attn+gate": qkv + wo + ffn}[remat]
    return cfg.n_layers * (layer + recompute) + 3 * 2 * bt * d * v


def _run(cfg, batch, timer, steps=3, zero=None, fused=None):
    if fused is not None:
        fusion.set_jit_fusion(fused)
    try:
        ts = train_step.make_split_train_step(
            lambda p, d: tl.llama_loss(p, d, cfg, device="cpu"),
            precision.fused_adam(1e-3), telemetry=timer, zero=zero)
        carry = ts.init(tl.llama_init(cfg, torch.Generator().manual_seed(0),
                                      device="cpu"))
        losses = []
        for _ in range(steps):
            loss, carry = ts.step(carry, batch)
            losses.append(loss.detach().clone())
    finally:
        fusion.set_jit_fusion(None)
    return losses


@pytest.mark.parametrize("remat", ["none", "full", "attn+gate"])
def test_split_step_counts_its_matmuls(remat):
    cfg, batch = _llama(remat)
    timer = ttel.StepTimer()
    losses = _run(cfg, batch, timer)
    assert timer.steps == 3 and timer.mean_step_s() > 0
    assert timer.flops_per_step == _analytic_flops(cfg, remat)
    row = timer.summary()
    assert row["steps"] == 3 and row["mfu"] > 0
    # The timer changes nothing inside the step.
    assert [x.tolist() for x in losses] == \
        [x.tolist() for x in _run(cfg, batch, None)]


@pytest.mark.parametrize("fused", [False, True])
def test_zero_split_step_under_telemetry(fused):
    cfg, batch = _llama("attn+gate")
    timer = ttel.StepTimer()
    losses = _run(cfg, batch, timer, zero=Z.ZeroConfig(size=1),
                  fused=fused)
    assert timer.steps == 3
    assert timer.flops_per_step == _analytic_flops(cfg, "attn+gate")
    assert [x.tolist() for x in losses] == \
        [x.tolist() for x in _run(cfg, batch, None)]


def test_flops_beside_jax_cost_analysis():
    """JAX's CPU ``cost_analysis()`` of its grad program
    (``horovod_tpu/parallel/train_step.py:84``) on the same model and
    batch, beside the port's count: XLA also counts elementwise work and
    counts the model's program its own way (on this model it reports
    about 0.6 of the matmul count), so the two are held within a factor
    of 2, not equal."""
    from horovod_tpu.models import llama as jl

    cfg, batch = _llama("none")
    timer = ttel.StepTimer()
    _run(cfg, batch, timer, steps=1)
    jcfg = jl.LlamaConfig.tiny(dtype="float32", param_dtype="float32",
                               remat="none")
    params = jl.llama_init(jcfg, jax.random.PRNGKey(0))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    grad = jax.jit(jax.value_and_grad(
        lambda p, d: jl.llama_loss(p, d, jcfg)))
    cost = grad.lower(params, jbatch).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    ratio = cost["flops"] / timer.flops_per_step
    print(f"JAX cost_analysis {cost['flops']:.0f} / port "
          f"{timer.flops_per_step:.0f} = {ratio:.4f}")
    assert 0.5 <= ratio <= 2.0, ratio


# ---- step windows: one owner a window ----------------------------------


class _FakeBasics:
    """The replay of ``tests/single/test_telemetry.py``'s fake: step ids
    restart after ``metrics_reset``."""

    def __init__(self):
        self.next_id = 0
        self.open = -1

    def step_mark(self, begin=True):
        if begin:
            self.open = self.next_id
            self.next_id += 1
            return self.open
        sid, self.open = self.open, -1
        return sid

    def step_id(self):
        return self.open

    def metrics_reset(self):
        self.next_id = 0
        self.open = -1

    def metrics(self):
        raise RuntimeError("no lane")


def test_step_window_single_owner_after_id_reuse(monkeypatch):
    monkeypatch.setattr(tcore, "_basics", _FakeBasics())
    monkeypatch.setattr(tcore, "_window_owner", None)
    monkeypatch.setattr(tfo, "_last_boundary_id", None)
    tfo._mark_optimizer_step()
    assert tcore.step_id() == 0 and tcore.window_owner() == "optimizer"
    assert tfo._last_boundary_id == 0
    tcore.metrics_reset()
    assert tcore.window_owner() is None
    timer = ttel.StepTimer(block=False)
    timer.start_step()
    assert tcore.step_id() == 0       # the optimizer's remembered id
    tfo._mark_optimizer_step()        # must defer to the explicit scope
    assert tcore.step_id() == 0 and tcore.window_owner() == "StepTimer"
    timer.end_step()
    assert tcore.step_id() == -1 and tcore.window_owner() is None
    tfo._mark_optimizer_step()
    assert tcore.window_owner() == "optimizer"


def test_step_timer_refuses_stolen_window(monkeypatch):
    monkeypatch.setattr(tcore, "_basics", _FakeBasics())
    monkeypatch.setattr(tcore, "_window_owner", None)
    timer = ttel.StepTimer(block=False)
    timer.start_step()
    tcore.step_mark(False)
    tcore.step_mark(True, owner="optimizer")
    with pytest.raises(RuntimeError, match="owned by 'optimizer'"):
        timer.end_step()
    tcore.step_mark(False)
    timer.start_step()
    timer.end_step()


# ---- bubbles and predictors --------------------------------------------


@pytest.mark.parametrize("case", [
    ("gpipe", 4, 8, 1, 0.2, 0.01), ("1f1b", 4, 8, 1, 0.25, 0.01),
    ("interleaved_1f1b", 4, 8, 2, 0.35, 0.01),
    ("interleaved_1f1b", 2, 5, 3, 0.5, 0.02)])
def test_bubbles_match_jax(case):
    schedule, S, M, V, step_s, sub_s = case
    assert ttel.analytic_bubble(schedule, S, M, V) == \
        jtel.analytic_bubble(schedule, S, M, V)
    assert ttel.measured_bubble(step_s, sub_s, M, V) == \
        jtel.measured_bubble(step_s, sub_s, M, V)
    assert ttel.bubble_report(schedule, S, M, V, step_s, sub_s) == \
        jtel.bubble_report(schedule, S, M, V, step_s, sub_s)
    for pkg in (ttel, jtel):
        with pytest.raises(ValueError):
            pkg.measured_bubble(0, sub_s, M, V)


def _mlp():
    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.ones(16, 32), "w2": torch.ones(32, 4),
              "b": torch.zeros(4, dtype=torch.bfloat16)}
    batch = {"x": torch.randn(8, 16, generator=g), "y": torch.zeros(8, 4)}

    def loss(p, d):
        h = torch.tanh(d["x"] @ p["w1"])
        return torch.mean((h @ p["w2"] + p["b"].float() - d["y"]) ** 2)

    def jloss(p, d):
        h = jnp.tanh(d["x"] @ p["w1"])
        return jnp.mean((h @ p["w2"] + p["b"].astype(jnp.float32)
                         - d["y"]) ** 2)

    jparams = {"w1": jnp.ones((16, 32)), "w2": jnp.ones((32, 4)),
               "b": jnp.zeros(4, jnp.bfloat16)}
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    return loss, params, batch, jloss, jparams, jbatch


def test_predictors_match_jax():
    loss, params, batch, jloss, jparams, jbatch = _mlp()
    got = tpredict.eager_allreduce_bytes(loss, params, batch)
    assert got == jpredict.eager_allreduce_bytes(jloss, jparams, jbatch)
    assert got == tpredict.grad_tree_bytes(loss, params, batch) == \
        jpredict.grad_tree_bytes(jloss, jparams, jbatch)
    for size, bucket in ((2, None), (3, 256), (4, 1 << 10)):
        got = tpredict.eager_zero_bytes(loss, params, batch, size=size,
                                        bucket_bytes=bucket)
        assert got == jpredict.eager_zero_bytes(
            jloss, jparams, jbatch, size=size, bucket_bytes=bucket)
        leaves = [params[k] for k in sorted(params)]
        layout = Z.zero_bucket_layout(leaves, size, bucket or
                                      Z.DEFAULT_BUCKET_BYTES)
        assert tpredict.zero_layout_bytes(layout) == got
    for args in ((1000, 4, 4, 2, 1), (1001, 2, 8, 4, 5),
                 (77, 4, 6, 3, 4)):
        for kw in ({}, {"compressed": True}, {"compress_cross": True}):
            assert tpredict.hier_allreduce_wire_bytes(*args, **kw) == \
                jpredict.hier_allreduce_wire_bytes(*args, **kw)
        count, item, size, _, rank = args
        assert tpredict.flat_ring_wire_bytes(count, item, size, rank) == \
            jpredict.flat_ring_wire_bytes(count, item, size, rank)
    sig = [tpredict.Collective("psum_scatter", 64, "float32"),
           tpredict.Collective("all_gather", 16, "bfloat16")]
    assert tpredict.zero_signature_bytes(sig, 4) == 64 * 4 + 16 * 2 * 4
    assert tpredict.signature_bytes(sig) == 64 * 4 + 16 * 2


def test_redistribute_bytes_match_jax():
    from horovod_tpu.parallel import reshard as jreshard

    from horovod_tpu_torch.parallel import reshard as treshard

    def as_jax(layout):
        return jreshard.Layout(layout.kind, layout.nranks,
                               tuple(layout.rows))

    for src, dst in ((treshard.Layout.sharded(37, 4),
                      treshard.Layout.replicated(4)),
                     (treshard.Layout.sharded(37, 4),
                      treshard.Layout.from_rows([(0, 20), (20, 17),
                                                 (37, 0), (37, 0)]))):
        plan = treshard.plan_redistribute((37, 5), np.float32, src, dst)
        jplan = jreshard.plan_redistribute((37, 5), np.float32,
                                           as_jax(src), as_jax(dst))
        for rank in (None, 0, 3):
            assert tpredict.redistribute_bytes(plan, rank) == \
                jpredict.redistribute_bytes(jplan, rank)


# ---- the overlap ledger and the exporters ------------------------------


def test_overlap_ledger_against_its_offline_twin():
    """The ledger's fold against ``critpath``'s interval math: spans
    clipped to the window, exposed = their measure under the union of
    the waits, hidden = total - exposed exactly, clipped-off and
    outside time unattributed."""
    from horovod_tpu.telemetry import critpath as jcrit

    rng = np.random.default_rng(0)
    ledger = metrics.OverlapLedger()
    ledger.add_span(0, 0, 40)        # before any window: unattributed
    lo, hi = 100, 1000
    ledger.step_begin(lo)
    spans = {0: [], 1: []}
    unattributed = 40
    for _ in range(40):
        a = int(rng.integers(50, 1050))
        b = a + int(rng.integers(0, 60))
        plane = int(rng.integers(0, 2))
        ledger.add_span(plane, a, b)
        if b > lo:
            spans[plane].append((a, b))
        else:                        # ends at or before the window
            unattributed += b - a
    waits = []
    for _ in range(15):
        a = int(rng.integers(0, 1100))
        waits.append((a, a + int(rng.integers(1, 90))))
        ledger.add_wait(*waits[-1])
    assert ledger.step_end(hi) == hi - lo
    ov = ledger.json()
    wait_in = [(max(a, lo), min(b, hi)) for a, b in waits
               if b > lo and min(b, hi) > max(a, lo)]
    for plane, name in ((0, "intra"), (1, "cross")):
        clipped = [(max(a, lo), min(b, hi)) for a, b in spans[plane]
                   if min(b, hi) >= max(a, lo)]
        total = sum(b - a for a, b in clipped)
        exposed = sum(jcrit.union_measure(
            jcrit.intersect_intervals([iv], wait_in)) for iv in clipped)
        unattributed += sum(b - a for a, b in spans[plane]) - total
        p = ov[name]
        assert (p["total_us"], p["exposed_us"]) == (total, exposed)
        assert p["exposed_us"] + p["hidden_us"] == p["total_us"]
        assert p["last_total_us"] == total
    assert ov["unattributed_us"] == unattributed
    assert ov["steps"] == 1
    assert ledger.step_end(hi) == -1


def test_prometheus_overlap_series_match_jax():
    from horovod_tpu.telemetry.exporters import _flatten_prom as jprom

    from horovod_tpu_torch.telemetry.exporters import _flatten_prom

    ledger = metrics.OverlapLedger()
    ledger.step_begin(0)
    ledger.add_span(0, 10, 50)
    ledger.add_span(1, 60, 80)
    ledger.add_wait(20, 70)
    ledger.step_end(100)
    snap = {"wire": {"overlap": ledger.json()}}

    def overlap(text):
        return [ln for ln in text.splitlines()
                if ln.startswith("hvdtpu_overlap_")]

    assert overlap(_flatten_prom(snap, 1)) == overlap(jprom(snap, 1))
    assert len(overlap(jprom(snap, 1))) == 11


def test_scraper_writes_its_three_sinks(tmp_path, capsys):
    scraper = ttel.MetricsScraper(interval_s=3600,
                                  jsonl_path=str(tmp_path / "m.jsonl"),
                                  prom_path=str(tmp_path / "m.prom"),
                                  console=True)
    with scraper:
        pass                           # stop() takes the final scrape
    scraper.scrape_once()
    rows = [json.loads(ln) for ln in
            (tmp_path / "m.jsonl").read_text().splitlines()]
    assert len(rows) == 2 == scraper.scrapes
    assert rows[0]["serving"]["kv_blocks_total"] == -1
    assert "overlap" in rows[0]["wire"] and "ts" in rows[0]
    for line in (tmp_path / "m.prom").read_text().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    assert "-- hvdtpu metrics (rank -1/0) --" in capsys.readouterr().err


# ---- the black box -----------------------------------------------------


def _header_keys_of_the_core():
    """The JSON keys ``DumpBlackBox`` writes into its header line."""
    src = (REPO / "csrc" / "operations.cc").read_text()
    body = src[src.index("void DumpBlackBox("):]
    body = body[:body.index("\n}\n")]
    return re.findall(r'\\"(\w+)\\":', body)


def test_blackbox_header_has_the_cores_fields(tmp_path, monkeypatch):
    monkeypatch.setenv("HOROVOD_BLACKBOX_DIR", str(tmp_path / "bb"))
    events.record("wait", c=7)
    path = events.dump_blackbox(3, 4, 2, "peer", True, [1], 1234,
                                'lost "peer"')
    lines = pathlib.Path(path).read_text().splitlines()
    header = json.loads(lines[0])
    keys = _header_keys_of_the_core()
    fault_at = keys.index("fault")
    assert list(header) == keys[:fault_at + 1]
    assert list(header["fault"]) == keys[fault_at + 1:]
    assert header["kind"] == "blackbox_header"
    assert (header["rank"], header["size"], header["epoch"]) == (3, 4, 2)
    assert header["fault"] == {"kind": "peer", "certain": True,
                               "ranks": [1], "detect_ms": 1234,
                               "reason": 'lost "peer"'}
    evs = [json.loads(ln) for ln in lines[1:]]
    assert evs == events.peek()[-len(evs):] and evs[-1]["type"] == "wait"
    # Both post-mortem readers take the file.
    from horovod_tpu.telemetry import postmortem as jpm

    assert jpm.load_blackbox(path) == ttel.postmortem.load_blackbox(path)
    for off in ("off", "none", "0"):
        monkeypatch.setenv("HOROVOD_BLACKBOX_DIR", off)
        assert events.dump_blackbox(0, 1, 0, "peer", True, [0], 0, "") \
            is None
