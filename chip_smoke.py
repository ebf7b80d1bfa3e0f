#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``horovod_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA card of
compute capability >= 9.0::

    python3 chip_smoke.py

It builds the port's hand-written kernels from the checkout's sources
and drives the port's serving and training paths at the full width of
the flagship dense Llama, in phases; any failed phase exits non-zero
before the result line.

1. Card, power limit, torch/CUDA versions; kernel build time.
2. Each kernel against its plain PyTorch version at the main paths'
   shapes (and a long prompt / long cache / ragged T): max error,
   kernel, plain and library times, and the card's bound for the same
   work. K1 forward, K2/K3 backward (dq, dk, dv), K4 decode.
3. ``llama_generate``: greedy, batch 16, prompt 128, 64 new tokens;
   K1 must launch once per layer, K4 once per layer per decode step.
4. ``DecodeEngine``: 16 requests of 17-128 prompt tokens, 32 new
   tokens each, all arriving at once; K1 once per layer per prefill.
5. Parity: at flagship widths in f32 (2 layers), the engine's tokens
   equal ``llama_generate``'s for every request, with requests admitted
   mid-flight.
6. Training: ``make_split_train_step(llama_loss, fused_adam(3e-4))`` at
   batch 4 x 2048 tokens, ``remat="attn+gate"``, bf16 params: one
   warm-up step, 5 timed steps on one fixed batch; K1, K2 and K3 must
   each launch 14 times per grad call and the loss must fall. Also the
   lm_head's f32-output product (which path this torch takes, its cost).
7. Training parity: at flagship widths in f32 (2 layers, batch 2 x
   256), loss and gradients on the card match the plain CPU path, and
   the remat modes none/full/attn/attn+gate agree with K1 launching
   2/4/2/2 times per grad call.
8. A ``kernels`` JSON line, the card line, and the result line
   ``{"ok": true, "device": {...}}``.

Weights are random (``torch.Generator`` seed 0); nothing is downloaded.
"""

import dataclasses
import json
import re
import subprocess
import sys
import time
import traceback

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense bf16; f32 FMA


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved, flops, dtype_name):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _kernel_name(mangled):
    """``name<dtype, D>`` of a mangled kernel ``_ZN<len><id>...``: the
    nested identifier ending in ``_kernel``, then its template
    arguments."""
    i = 3
    while m := re.match(r"\d+", mangled[i:]):
        start = i + m.end()
        i = start + int(m.group())
        name = mangled[start:i]
        if name.endswith("_kernel"):
            args = re.match(r"I(13__nv_bfloat16|f)(?:Li(\d+)E)?",
                            mangled[i:])
            if not args:
                return name
            dt = "bf16" if args.group(1) != "f" else "f32"
            return f"{name}<{dt}" + (f", D{args.group(2)}>"
                                     if args.group(2) else ">")
    return "?"


def ptxas_summary(text):
    """One line per compiled kernel from nvcc's -Xptxas=-v output: its
    name with dtype and head dim, registers and spills."""
    out, name, spill = [], "?", ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {spill}")
            name, spill = "?", ""
    return out


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def device_profile(torch, label, fn, top=6):
    """Run ``fn`` under torch.profiler and print the wall time, the
    device's busy time (sum of kernel durations), its idle share and the
    kernels that took the most time. The profiler slows the host, so the
    idle share read here is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_kernel = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) \
                + e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_kernel.values())
    if not busy_ms:
        log(f"  profile {label}: no device time recorded (not measured)")
        return None
    out = dict(wall_ms=wall_ms, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms,
               top=[(name[:60], ms) for name, ms in sorted(
                   by_kernel.items(), key=lambda kv: -kv[1])[:top]])
    log(f"  profile {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_ms:.2f} ms, idle share {out['idle_share']:.3f}")
    for name, ms in out["top"]:
        log(f"    {ms:9.3f} ms  {name}")
    return out


# ---- phase 2: kernels against their plain versions ---------------------


def flash_case(torch, fa, b, t, dtype, iters, h=16, hkv=4, d=128):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 1000 + t)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, h, t, d), (b, hkv, t, d), (b, hkv, t, d)))
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    o_ref, lse_ref = fa._flash_fwd_reference(q, k, v, True)
    torch.cuda.synchronize()
    err = float((o.float() - o_ref.float()).abs().max())
    lse_err = float((lse - lse_ref).abs().max())
    kernel_ms = cuda_ms(torch, lambda: fa._flash_fwd_cuda(q, k, v, True),
                        iters)
    plain_ms = cuda_ms(torch,
                       lambda: fa._flash_fwd_reference(q, k, v, True),
                       max(1, iters // 4), warmup=1)
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters)
    # Causal work: each query row attends to itself and the rows before.
    pairs = b * h * t * (t + 1) // 2
    dname = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(nbytes(q, k, v, o, lse), 4 * pairs * d,
                               dname)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"K1 B{b} H{h} Hkv{hkv} T{t} D{d} {dname}"
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), lse_err "
        f"{lse_err:.3e} (tol 1e-3), kernel {kernel_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    check(err <= tol, f"{name}: output error {err} above {tol}")
    check(lse_err <= 1e-3, f"{name}: lse error {lse_err} above 1e-3")
    return dict(case=name, max_abs_err=err, lse_max_abs_err=lse_err,
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def bwd_case(torch, fa, b, t, dtype, iters, h=16, hkv=4, d=128):
    """K2 and K3 against the plain backward on the same q, k, v, do and
    K1's o and lse (causal)."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 1000 + t + 7)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(dtype)
                   for shape in ((b, h, t, d), (b, hkv, t, d),
                                 (b, hkv, t, d), (b, h, t, d)))
    o, lse = fa._flash_fwd_cuda(q, k, v, True)
    got = fa._flash_bwd_cuda(q, k, v, o, lse, do, True)
    want = fa._flash_bwd_reference(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    abs_err, rel_err = {}, {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        abs_err[name] = float((a.float() - w.float()).abs().max())
        rel_err[name] = abs_err[name] / max(float(w.float().abs().max()),
                                            1e-30)
    delta = fa._delta(o, do)
    k2_ms = cuda_ms(torch, lambda: fa._flash_bwd_dkv_cuda(
        q, k, v, do, lse, delta, True), iters)
    k3_ms = cuda_ms(torch, lambda: fa._flash_bwd_dq_cuda(
        q, k, v, do, lse, delta, True), iters)
    pair_ms = cuda_ms(torch, lambda: fa._flash_bwd_cuda(
        q, k, v, o, lse, do, True), iters)
    plain_ms = cuda_ms(torch, lambda: fa._flash_bwd_reference(
        q, k, v, o, lse, do, True), max(1, iters // 4), warmup=1)
    # Library: SDPA's backward alone, on a saved SDPA forward (the port
    # never calls it).
    qg, kg, vg = (x.detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                         enable_gqa=True)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), iters)
    pairs = b * h * t * (t + 1) // 2
    dname = str(dtype).replace("torch.", "")
    reads = nbytes(q, k, v, do, lse, delta)
    # K2 writes dk/dv per query head (got[1], got[2]), K3 writes dq.
    k2_bound, k2_by = bound(reads + nbytes(got[1], got[2]), 8 * d * pairs,
                            dname)
    k3_bound, k3_by = bound(reads + nbytes(got[0]), 6 * d * pairs, dname)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"B{b} H{h} Hkv{hkv} T{t} D{d} {dname} causal"
    log(f"  K2/K3 {name}: rel err dq {rel_err['dq']:.3e} dk "
        f"{rel_err['dk']:.3e} dv {rel_err['dv']:.3e} (tol {tol:g}, of "
        f"the reference's max abs); K2 {k2_ms:.4f} ms (bound {k2_bound:.4f}"
        f" {k2_by}), K3 {k3_ms:.4f} ms (bound {k3_bound:.4f} {k3_by}), "
        f"pair {pair_ms:.4f} ms, plain {plain_ms:.4f} ms, library (SDPA "
        f"backward) {library_ms:.4f} ms")
    for grad, err in rel_err.items():
        check(err <= tol, f"K2/K3 {name}: {grad} error {err} above {tol}")
    common = dict(plain_ms=plain_ms, library_ms=library_ms, pair_ms=pair_ms)
    return (dict(case=f"K2 {name}", max_abs_err=max(abs_err["dk"],
                                                    abs_err["dv"]),
                 rel_err={k: rel_err[k] for k in ("dk", "dv")}, ms=k2_ms,
                 bound_ms=k2_bound, bound_by=k2_by, **common),
            dict(case=f"K3 {name}", max_abs_err=abs_err["dq"],
                 rel_err={"dq": rel_err["dq"]}, ms=k3_ms,
                 bound_ms=k3_bound, bound_by=k3_by, **common))


def decode_case(torch, da, b, hkv, n_rep, s, pos, dtype, iters, d=128):
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(b * 7 + s)
    h = hkv * n_rep
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(dtype)
    ck = torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
    cv = torch.randn((b, hkv, s, d), generator=g, device="cuda").to(dtype)
    out = da._decode_attention_cuda(q, ck, cv, pos)
    ref = da._decode_attention_reference(q, ck, cv, pos)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    kernel_ms = cuda_ms(
        torch, lambda: da._decode_attention_cuda(q, ck, cv, pos), iters)
    plain_ms = cuda_ms(
        torch, lambda: da._decode_attention_reference(q, ck, cv, pos),
        max(1, iters // 4), warmup=1)
    qt = q.transpose(1, 2)                      # [B, H, 1, D]
    kv_k, kv_v = ck[:, :, :pos + 1], cv[:, :, :pos + 1]
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kv_k, kv_v, enable_gqa=True), iters)
    n_valid = min(pos + 1, s)
    read = 2 * b * hkv * n_valid * d * ck.element_size()
    dname = str(dtype).replace("torch.", "")
    bound_ms, bound_by = bound(read + nbytes(q, out),
                               4 * b * h * n_valid * d, dname)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    name = f"K4 B{b} Hkv{hkv} n_rep{n_rep} S{s} pos{pos} D{d} {dname}"
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g}), kernel "
        f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    check(err <= tol, f"{name}: error {err} above {tol}")
    return dict(case=name, max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


# ---- phases 3-5: the serving path --------------------------------------


def flagship_config(LlamaConfig):
    """The dense flagship of the repo's bench (bench.py _flagship_cfg):
    ~1.43 B parameters, bf16 compute and storage."""
    return LlamaConfig(vocab_size=32768, d_model=2048, n_layers=14,
                       n_heads=16, n_kv_heads=4, d_ff=13312,
                       dtype="bfloat16", remat="attn+gate",
                       param_dtype="bfloat16")


def _counters(fa, da):
    return {"K1": fa._flash_fwd_cuda, "K2": fa._flash_bwd_dkv_cuda,
            "K3": fa._flash_bwd_dq_cuda, "K4": da._decode_attention_cuda}


def reset_counts(fa, da):
    for fn in _counters(fa, da).values():
        fn.launches = 0


def counts(fa, da):
    return {k: fn.launches for k, fn in _counters(fa, da).items()}


def run_generate(torch, fa, da, gen, params, cfg, batch, prompt_len,
                 new):
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(
        np.int32)
    gen.llama_generate(params, prompt[:, :8], cfg, 2)     # warm-up
    torch.cuda.synchronize()
    reset_counts(fa, da)
    t0 = time.perf_counter()
    out = gen.llama_generate(params, prompt, cfg, new)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = counts(fa, da)
    t0 = time.perf_counter()
    first, _, _ = gen.llama_prefill(params, prompt, cfg)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    out = out.cpu().numpy()
    check(out.shape == (batch, prompt_len + new), f"shape {out.shape}")
    check((out[:, :prompt_len] == prompt).all(), "prompt not preserved")
    check(((out >= 0) & (out < cfg.vocab_size)).all(), "token off vocab")
    check((out[:, prompt_len] == first.cpu().numpy()).all(),
          "first token differs from llama_prefill's")
    L = cfg.n_layers
    check(launched["K1"] == L,
          f"K1 launched {launched['K1']} times, expected {L}")
    check(launched["K4"] == L * (new - 1),
          f"K4 launched {launched['K4']} times, expected {L * (new - 1)}")
    step_ms = (total_s - prefill_s) / (new - 1) * 1e3
    param_bytes = sum(nbytes(w) for w in params["layers"].values()) + \
        nbytes(params["lm_head"], params["final_norm"])
    log(f"  llama_generate b{batch} prompt {prompt_len} new {new}: "
        f"{total_s:.3f} s total, prefill {prefill_s * 1e3:.2f} ms, decode "
        f"{step_ms:.3f} ms/step, {batch * new / total_s:.1f} tok/s; "
        f"launches {launched}; weight-stream bound "
        f"{param_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms/step")
    prof = device_profile(
        torch, f"llama_generate b{batch} prompt {prompt_len} new 17",
        lambda: gen.llama_generate(params, prompt, cfg, 17))
    return launched, dict(total_s=total_s, prefill_ms=prefill_s * 1e3,
                          decode_ms_per_step=step_ms,
                          tok_s=batch * new / total_s, profile=prof)


def run_engine(torch, fa, da, DecodeEngine, Request, params, cfg):
    rng = np.random.default_rng(1)
    n_req, new = 16, 32
    lens = rng.integers(17, 129, n_req)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, int(n))
                    .astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(lens)]
    eng = DecodeEngine(params, cfg, block_size=32, n_blocks=128,
                       max_batch=16, max_context=128 + new, device="cuda")
    reset_counts(fa, da)
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_idle()
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launched = counts(fa, da)
    check(eng.scheduler.evictions == 0, "engine evicted under no pressure")
    check(sorted(done) == list(range(n_req)), "not every request completed")
    for r in reqs:
        toks = done[r.rid]
        check(len(toks) == len(r.prompt) + new, f"request {r.rid} length")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(),
              f"request {r.rid}: token off vocab")
    check(launched["K1"] == cfg.n_layers * n_req,
          f"K1 launched {launched['K1']} times, expected "
          f"{cfg.n_layers * n_req}")
    log(f"  DecodeEngine {n_req} requests (prompts {int(lens.min())}-"
        f"{int(lens.max())}, {new} new each): {total_s:.3f} s, "
        f"{eng.steps} steps, {n_req * new / total_s:.1f} tok/s; "
        f"launches {launched}")
    small = DecodeEngine(params, cfg, block_size=32, n_blocks=128,
                         max_batch=16, max_context=128 + new, device="cuda")

    def drive_small():
        for r in reqs[:4]:
            small.submit(Request(rid=r.rid, prompt=r.prompt,
                                 max_new_tokens=8))
        small.run_until_idle()

    prof = device_profile(torch, "DecodeEngine 4 requests x 8 new",
                          drive_small)
    return launched, dict(total_s=total_s, steps=eng.steps,
                          tok_s=n_req * new / total_s, profile=prof)


def run_parity(gen, DecodeEngine, poisson_trace, llama_init, torch, cfg):
    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                              param_dtype="float32")
    params = llama_init(c32, torch.Generator(device="cuda").manual_seed(1),
                        device="cuda")
    eng = DecodeEngine(params, c32, block_size=8, n_blocks=64, max_batch=4,
                       max_context=32, device="cuda")
    trace = poisson_trace(6, 1000.0, seed=5, prompt_len=(4, 12),
                          max_new=(3, 8), vocab_size=c32.vocab_size)
    for r in trace[:3]:
        eng.submit(r)
    for _ in range(2):
        eng.step()
    for r in trace[3:]:
        eng.submit(r)
    done = eng.run_until_idle()
    for r in trace:
        ref = gen.llama_generate(params, r.prompt[None, :], c32,
                                 r.max_new_tokens)[0].cpu().numpy()
        check(np.array_equal(done[r.rid], ref),
              f"request {r.rid}: engine {done[r.rid].tolist()} != "
              f"llama_generate {ref.tolist()}")
    log(f"  f32 parity: {len(trace)} requests, engine tokens == "
        f"llama_generate tokens")


# ---- phases 6-7: the training path -------------------------------------


def logits_case(torch, llama, cfg, tokens):
    """The lm_head product at the train step's shape: the path this
    torch takes (mm with out_dtype=float32, or the f32 upcast), its
    agreement with the f32 product of the upcast operands, and the
    forward and backward times of both."""
    g = torch.Generator(device="cuda").manual_seed(11)
    h = torch.randn((tokens, cfg.d_model), generator=g,
                    device="cuda").bfloat16().requires_grad_(True)
    w = (torch.randn((cfg.d_model, cfg.vocab_size), generator=g,
                     device="cuda") * cfg.d_model ** -0.5).bfloat16()
    out = llama._F32Logits.apply(h, w)
    ref = torch.mm(h.detach().float(), w.float())
    gout = torch.randn_like(out)
    torch.cuda.synchronize()
    err = float((out.detach() - ref).abs().max() / ref.abs().max())
    fwd_ms = cuda_ms(torch, lambda: llama._F32Logits.apply(h.detach(), w),
                     5)
    upcast_ms = cuda_ms(torch, lambda: torch.mm(h.detach().float(),
                                                w.float()), 5)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        out, h, gout, retain_graph=True), 5)
    path = "mm(out_dtype=float32)" if llama._MM_OUT_DTYPE else \
        "f32 upcast"
    log(f"  lm_head logits [{tokens}, {cfg.d_model}] x [{cfg.d_model}, "
        f"{cfg.vocab_size}]: path {path}, rel err vs f32 upcast {err:.3e} "
        f"(tol 1e-4), forward {fwd_ms:.3f} ms (f32 upcast {upcast_ms:.3f} "
        f"ms), backward (f32 products) {bwd_ms:.3f} ms")
    check(err <= 1e-4, f"lm_head logits error {err} above 1e-4")
    return dict(path=path, rel_err=err, fwd_ms=fwd_ms,
                upcast_fwd_ms=upcast_ms, bwd_ms=bwd_ms)


def run_train(torch, fa, da, llama, precision, train_step, cfg, batch,
              seq, steps, card):
    params = llama.llama_init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (
        batch, seq)).astype(np.int32)).cuda()
    data = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    ts = train_step.make_split_train_step(
        lambda p, d: llama.llama_loss(p, d, cfg), precision.fused_adam(3e-4))
    carry = ts.init(params)
    del params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, carry = ts.step(carry, data)                      # warm-up
    losses = [loss]
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    reset_counts(fa, da)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, carry = ts.step(carry, data)
        losses.append(loss)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / steps
    launched = counts(fa, da)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    L = cfg.n_layers
    for k in ("K1", "K2", "K3"):
        check(launched[k] == L * steps,
              f"{k} launched {launched[k]} times in {steps} steps, "
              f"expected {L} per grad call")
    check(launched["K4"] == 0, "the train step launched K4")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tok = batch * seq
    flops_per_token = 6 * n_params + 12 * L * seq * cfg.d_model
    mfu = flops_per_token * tok / dt / PEAK_FLOPS["bfloat16"]
    log(f"  train step B{batch} T{seq} remat={cfg.remat} bf16 fused_adam: "
        f"{dt * 1e3:.1f} ms/step, {tok / dt:.0f} tok/s, MFU {mfu:.4f} "
        f"((6N + 12 L T d) per token at 989 TFLOP/s), peak memory "
        f"{peak / 2**30:.2f} GiB, first step {first_s:.2f} s; losses "
        f"{[round(x, 4) for x in losses]}; launches {launched} (per grad "
        f"call: {L} each); card {card}")
    logits = logits_case(torch, llama, cfg, tok)
    prof = device_profile(torch, f"train step B{batch} T{seq}",
                          lambda: ts.step(carry, data), top=10)
    return launched, dict(ms_per_step=dt * 1e3, tok_s=tok / dt, mfu=mfu,
                          peak_mem_gib=peak / 2**30, first_step_s=first_s,
                          losses=losses, n_params=n_params, logits=logits,
                          profile=prof)


def run_train_parity(torch, fa, da, llama, train_step, cfg):
    """f32, 2 layers, B2 T256: the card's loss and gradients against the
    plain CPU path; the remat modes against each other on the card."""
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map

    c32 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                              param_dtype="float32", remat="none")
    cpu_params = llama.llama_init(c32, torch.Generator().manual_seed(3),
                                  device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, c32.vocab_size, (2, 256)).astype(np.int32)
    batch = {"tokens": tokens, "targets": np.roll(tokens, -1, 1)}

    def value_and_grad(params, c, device):
        loss, grads = train_step._value_and_grad(
            lambda p, d: llama.llama_loss(p, d, c, device=device), params,
            batch, 1)
        return float(loss), [g.float().cpu() for g in tree_leaves(grads)]

    t0 = time.perf_counter()
    cpu_loss, cpu_grads = value_and_grad(cpu_params, c32, "cpu")
    cpu_s = time.perf_counter() - t0
    card_params = tree_map(lambda w: w.cuda(), cpu_params)
    del cpu_params
    results, k1 = {}, {}
    for mode in ("none", "full", "attn", "attn+gate"):
        reset_counts(fa, da)
        results[mode] = value_and_grad(card_params, dataclasses.replace(
            c32, remat=mode), "cuda")
        n = counts(fa, da)
        k1[mode] = n["K1"]
        check(n["K2"] == 2 and n["K3"] == 2,
              f"remat={mode}: K2/K3 launched {n['K2']}/{n['K3']}, "
              f"expected 2/2")

    def rel(got, want):
        return max(float((g - w).abs().max()) / max(float(w.abs().max()),
                                                     1e-30)
                   for g, w in zip(got, want))

    loss_err = abs(results["none"][0] - cpu_loss) / abs(cpu_loss)
    grad_err = rel(results["none"][1], cpu_grads)
    mode_err = {m: rel(results[m][1], results["none"][1])
                for m in ("full", "attn", "attn+gate")}
    log(f"  f32 train parity (2 layers, B2 T256): card vs CPU loss rel err "
        f"{loss_err:.3e} (tol 1e-5), grads {grad_err:.3e} (tol 2e-4 of "
        f"each leaf's max abs); remat vs none {mode_err} (tol 1e-5); K1 "
        f"launches per grad call {k1} (expected 2/4/2/2); CPU grad call "
        f"{cpu_s:.1f} s")
    check(loss_err <= 1e-5, f"card loss differs from CPU by {loss_err}")
    check(grad_err <= 2e-4, f"card grads differ from CPU by {grad_err}")
    for m, e in mode_err.items():
        check(e <= 1e-5, f"remat={m} grads differ from none by {e}")
    check(k1 == {"none": 2, "full": 4, "attn": 2, "attn+gate": 2},
          f"K1 launches per remat mode {k1}")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err,
                remat_rel_err=mode_err, k1_launches=k1)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "needs an NVIDIA card")
    try:
        from horovod_tpu_torch.models import generate as gen
        from horovod_tpu_torch.models import llama
        from horovod_tpu_torch.models.llama import LlamaConfig, llama_init
        from horovod_tpu_torch.ops import _build
        from horovod_tpu_torch.ops import decode_attention as da
        from horovod_tpu_torch.ops import flash_attention as fa
        from horovod_tpu_torch.parallel import precision, train_step
        from horovod_tpu_torch.serving.engine import DecodeEngine
        from horovod_tpu_torch.serving.scheduler import (
            Request,
            poisson_trace,
        )
    except ImportError as e:
        raise SmokeFailure(f"horovod_tpu_torch not importable ({e}): run "
                           "from the root of a repo checkout") from e
    # Full-f32 products everywhere: the parity phases compare f32 paths
    # token for token and gradient for gradient.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: card and build")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    cap = torch.cuda.get_device_capability(0)
    log(f"  card {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, capability {cap}, "
        f"{torch.cuda.device_count()} device(s)")
    check(cap >= (9, 0), f"needs compute capability >= 9.0, got {cap}")
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"  kernels built in {time.perf_counter() - t0:.1f} s "
        f"({', '.join(build_logs) or 'all cached'})")
    for name, text in build_logs.items():
        for line in ptxas_summary(text):
            log(f"    {name}: {line}")

    log("phase 2: kernels against their plain versions")
    bf16, f32 = torch.bfloat16, torch.float32
    k1 = [flash_case(torch, fa, 16, 128, bf16, 50),
          flash_case(torch, fa, 1, 77, bf16, 50),
          flash_case(torch, fa, 1, 4096, bf16, 5),
          flash_case(torch, fa, 4, 2048, bf16, 5),
          flash_case(torch, fa, 4, 128, f32, 20)]
    bwd = [bwd_case(torch, fa, 4, 2048, bf16, 5),
           bwd_case(torch, fa, 1, 77, bf16, 20),
           bwd_case(torch, fa, 2, 256, f32, 10)]
    k2, k3 = [c[0] for c in bwd], [c[1] for c in bwd]
    k4 = [decode_case(torch, da, 16, 4, 4, 192, 150, bf16, 100),
          decode_case(torch, da, 1, 4, 4, 32768, 32767, bf16, 50),
          decode_case(torch, da, 16, 4, 4, 192, 150, f32, 50)]

    log("phase 3: llama_generate at flagship width")
    cfg = flagship_config(LlamaConfig)
    params = llama_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    n_params = sum(w.numel() for w in params["layers"].values()) + sum(
        params[k].numel() for k in ("embed", "final_norm", "lm_head"))
    log(f"  flagship: {n_params / 1e9:.3f} B params, "
        f"{n_params * 2 / 1e9:.2f} GB bf16")
    gen_launch, gen_stats = run_generate(torch, fa, da, gen, params, cfg,
                                         16, 128, 64)

    log("phase 4: DecodeEngine at flagship width")
    eng_launch, eng_stats = run_engine(torch, fa, da, DecodeEngine,
                                       Request, params, cfg)
    del params
    torch.cuda.empty_cache()

    log("phase 5: engine/generate token parity (f32, 2 layers)")
    run_parity(gen, DecodeEngine, poisson_trace, llama_init, torch, cfg)

    log("phase 6: training at flagship width")
    train_launch, train_stats = run_train(
        torch, fa, da, llama, precision, train_step, cfg, 4, 2048, 5, card)
    torch.cuda.empty_cache()

    log("phase 7: training parity (f32, 2 layers) and remat modes")
    parity = run_train_parity(torch, fa, da, llama, train_step, cfg)

    log("phase 8: results")
    log(json.dumps({"generate": gen_stats, "engine": eng_stats,
                    "train": train_stats, "train_parity": parity,
                    "card": card}))
    paths = {"llama_generate": gen_launch, "DecodeEngine": eng_launch,
             "train_step": train_launch}

    def row(name, source, replaces, key, cases):
        by_path = {p: n[key] for p, n in paths.items()}
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=sum(by_path.values()),
                    launches_by_path=by_path,
                    **{k: cases[0][k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by", "library_ms")},
                    cases=cases)

    kernels = [
        row("K1 flash_fwd", "horovod_tpu_torch/csrc/flash_fwd.cu",
            "horovod_tpu/ops/flash_attention.py:50", "K1", k1),
        row("K2 flash_bwd_dkv", "horovod_tpu_torch/csrc/flash_bwd.cu",
            "horovod_tpu/ops/flash_attention.py:134", "K2", k2),
        row("K3 flash_bwd_dq", "horovod_tpu_torch/csrc/flash_bwd.cu",
            "horovod_tpu/ops/flash_attention.py:208", "K3", k3),
        row("K4 decode_attention",
            "horovod_tpu_torch/csrc/decode_attention.cu",
            "horovod_tpu/ops/decode_attention.py:36", "K4", k4),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as e:  # every failed phase ends the run, loudly
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
