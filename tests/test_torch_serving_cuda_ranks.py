"""The disaggregated serving loop across four H100s, a decode rank
SIGKILLed mid-trace.

Runs only where four CUDA cards of capability >= 9.0 are visible
(``cuda_sm90`` marker); elsewhere it skips. The flagship dense Llama of
``chip_smoke.py`` (vocab 32768, d2048, L14, H16/Hkv4, d_ff 13312, bf16;
random weights from seed 0, as phase 27) is served by
``serving.service.ServingLoop`` over the NCCL lane (``hvd.init()``, one
card a rank; the control messages and the int8 KV blocks ride the lane's
gloo side): rank 0 the frontend (prefill on its card), ranks 1-3 decode
ranks on theirs. After a 4-request warm-up, 24 requests on a Poisson
trace (prompts of 17-128 tokens, 32 new each), int8 KV; rank 2 is
SIGKILLed at round
``KILL_ROUND``. Every request completes on the three survivors, and each
request's tokens are compared with one ``DecodeEngine`` serving the same
trace on rank 0's card alone (phase 27 (a)'s one-card path): the share
equal, each difference with the top-2 logit margin of the bf16 forward
at its first differing token. Printed: tok/s and p50/p99 latency of the
requests completed before and after the kill, the recovery's seconds
(the kill to the first round of the re-formed world), the round
timeline and each rank's seconds in the control allgathers, the KV
exchange, prefill-and-pack and decode steps. Each rank takes a quarter
of the host's cores for torch's CPU threads (the host pool's operations
run there); ``SERVE_THREADS`` overrides it.
"""

import json
import os
import signal
import tempfile
import time

import numpy as np
import pytest
import torch

from tests.test_torch_elastic_ranks import run_chaos

pytestmark = pytest.mark.cuda_sm90

N_REQUESTS = 24
KILL_ROUND = 12
VICTIM = 2
LOOP = dict(block_size=32, n_blocks=128, max_batch=16, max_context=160,
            steps_per_round=4, prefill_per_round=4)


def _config():
    from horovod_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=32768, d_model=2048, n_layers=14,
                       n_heads=16, n_kv_heads=4, d_ff=13312,
                       dtype="bfloat16", remat="attn+gate",
                       param_dtype="bfloat16")


def _trace(cfg):
    from horovod_tpu_torch.serving.scheduler import poisson_trace

    return poisson_trace(N_REQUESTS, 50.0, seed=1, prompt_len=(17, 128),
                         max_new=(32, 32), vocab_size=cfg.vocab_size)


def _timed(spent, key, fn):
    """``fn`` wrapped to add its seconds to ``spent[key]``."""
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            spent[key] = spent.get(key, 0.0) + time.perf_counter() - t0

    return call


def _serve(rank, size):
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import elastic as ce
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.serving.engine import DecodeEngine
    from horovod_tpu_torch.serving.service import ServingLoop

    # Four ranks share the host: a quarter of its cores each for the
    # pool's host-side operations (torch's default, every core per
    # process, made the decode steps ~7.5x slower on four H100s).
    torch.set_num_threads(int(os.environ.get("SERVE_THREADS") or max(
        1, (os.cpu_count() or 4) // 4)))
    hvd.init()
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = _config()
    params = llama.llama_init(cfg, torch.Generator(device=device)
                              .manual_seed(0), device=device)
    trace = _trace(cfg)
    marks = os.environ["SERVE_MARKS"]
    rounds = []

    def hook(loop, round_idx):
        if hvd.rank() == VICTIM and round_idx == KILL_ROUND and \
                hvd.size() == size:
            with open(os.path.join(marks, "kill.json"), "w") as f:
                json.dump({"wall": time.time()}, f)
            os.kill(os.getpid(), signal.SIGKILL)
        rounds.append((round_idx, time.time(), hvd.size()))

    # A warm-up trace first: a fresh process's first prefill and decode
    # steps pay seconds of one-time costs on the card.
    ServingLoop(params, cfg, trace[:4], quantized=True, device=device,
                **LOOP).run()
    loop = ServingLoop(params, cfg, trace, quantized=True, round_hook=hook,
                       device=device, **LOOP)
    # Where each rank's time goes: the control allgathers (waiting on the
    # slowest rank), the KV exchange, prefill-and-pack, decode steps.
    spent = {}
    ce._allgather_object = _timed(spent, "control", ce._allgather_object)
    loop._exchange_payloads = _timed(spent, "kv_exchange",
                                     loop._exchange_payloads)
    loop._pack_assignment = _timed(spent, "prefill_pack",
                                   loop._pack_assignment)
    loop.engine.step = _timed(spent, "decode_steps", loop.engine.step)
    rep = loop.run()
    torch.cuda.synchronize()
    out = {"rank": rank, "size": hvd.size(), "threads": torch.get_num_threads(),
           "spent_s": {k: round(v, 3) for k, v in spent.items()},
           "card": torch.cuda.get_device_name(device)}
    if hvd.rank() == 0:
        out.update(rounds=rounds, requeued=sorted(loop.requeued_rids),
                   completed={k: v.tolist()
                              for k, v in rep["completed"].items()},
                   latency_s=rep["latency_s"],
                   **{k: rep[k] for k in ("served", "faults_survived",
                                          "sustained_tok_s", "p50_ms",
                                          "p99_ms", "wall_s")})
        one = DecodeEngine(params, cfg, quantized=True, device=device, **{
            k: LOOP[k] for k in ("block_size", "n_blocks", "max_batch",
                                 "max_context")})
        for r in trace:
            one.submit(r)
        want = one.run_until_idle()
        diffs = {}
        for r in trace:
            got, ref = rep["completed"][r.rid], want[r.rid]
            if not np.array_equal(got, ref):
                i = int(np.argmax(got != ref))
                with torch.no_grad():
                    logits = llama.llama_forward(
                        params, torch.tensor(ref[None, :i], device=device),
                        cfg, device=device)[0, -1].float()
                top = torch.topk(logits, 2).values
                diffs[r.rid] = {"at": i, "margin": float(top[0] - top[1])}
        out["differences"] = diffs
    hvd.shutdown()
    return out


def _window(lat, arrivals, lo, hi, tokens):
    """tok/s, p50 and p99 (ms) of the requests completed in [lo, hi)
    seconds of the loop's clock."""
    done = {rid: arrivals[rid] + s for rid, s in lat.items()}
    mine = [rid for rid, t in done.items() if lo <= t < hi]
    if not mine:
        return {"requests": 0}
    ms = np.asarray([lat[rid] * 1e3 for rid in mine])
    return {"requests": len(mine),
            "tok_s": round(sum(tokens[rid] for rid in mine) / (hi - lo), 2),
            "p50_ms": round(float(np.percentile(ms, 50)), 3),
            "p99_ms": round(float(np.percentile(ms, 99)), 3)}


def test_flagship_served_by_four_cards_survives_a_killed_decode_rank():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs compute capability >= 9.0")
    with tempfile.TemporaryDirectory() as marks:
        ranks, _ = run_chaos(_serve, 4, victims={VICTIM}, timeout=900,
                             env={"SERVE_MARKS": marks})
        with open(os.path.join(marks, "kill.json")) as f:
            kill_wall = json.load(f)["wall"]
    r0 = ranks[0]
    assert sorted(ranks) == [0, 1, 3]
    assert all(r["size"] == 3 for r in ranks.values())
    assert r0["served"] == N_REQUESTS and r0["faults_survived"] == 1
    assert r0["requeued"], "the kill re-queued nothing"
    trace = _trace(_config())
    arrivals = {r.rid: r.arrival_t for r in trace}
    tokens = {r.rid: r.max_new_tokens for r in trace}
    start = r0["rounds"][0][1]
    kill = kill_wall - start
    back = next(t for _, t, n in r0["rounds"] if n == 3) - start
    before = _window(r0["latency_s"], arrivals, 0.0, kill, tokens)
    after = _window(r0["latency_s"], arrivals, kill, r0["wall_s"] + 1e-9,
                    tokens)
    equal = N_REQUESTS - len(r0["differences"])
    print(f"four cards, the flagship (bf16, int8 KV) served by 1 frontend "
          f"+ 3 decode ranks, rank {VICTIM} killed at round {KILL_ROUND}: "
          f"{r0['served']}/{N_REQUESTS} served, {r0['sustained_tok_s']} "
          f"tok/s overall (p50 {r0['p50_ms']} ms, p99 {r0['p99_ms']} ms); "
          f"before the kill {before}, after {after}; recovery "
          f"{back - kill:.3f} s (kill at {kill:.3f} s, re-formed world's "
          f"first round at {back:.3f} s); re-queued {r0['requeued']}; "
          f"equal to one card's engine {equal}/{N_REQUESTS}, differences "
          f"{r0['differences']}; rounds (round, s, size) "
          f"{[(r, round(t - start, 2), n) for r, t, n in r0['rounds']]}; "
          f"seconds by part and rank (torch threads "
          f"{[r['threads'] for r in ranks.values()]}): "
          f"{ {k: r['spent_s'] for k, r in ranks.items()} }; {r0['card']}")
