"""The serving lane's two-rank chaos drill.

    python -m horovod_tpu_torch.serving.serve_smoke [--cpu]

The port's copy of ``horovod_tpu/serving/serve_smoke.py``: rank 0 the
frontend (prefill), rank 1 a decode rank, a tiny f32 Llama (2 layers)
serving a 12-request Poisson trace with int8 paged KV shipped in pool
format over the lane's gloo side; rank 1 is SIGKILLed at round 6 with
sequences in flight. It asserts:

1. rank 0 takes the typed peer failure at the round boundary, re-forms
   a world of one in place, re-queues the dead rank's requests, and
   every request completes on the survivor;
2. every request's tokens equal those of one ``DecodeEngine`` serving
   the whole trace in one process with the same int8 pool (greedy; the
   engine's static shapes and the source-side quantization make a
   request's answer independent of where it was decoded); the count of
   requests equal to ``llama_generate``'s (no quantization) is printed,
   since int8 KV may move a near-tie (the reference's own int8 kill test
   fails that identity: ROADMAP.md queue C);
3. the victim died by SIGKILL (its exit code; a clean exit means the
   chaos never fired);
4. the survivor's request events (``telemetry/reqtrace.py``) stitch
   into one gap-free span chain per request, the phase sums equal to
   the wall time to the microsecond, with ``fault_requeue`` on exactly
   the re-queued requests.

The lane is gloo (``hvd.init(device="cpu")``, the KV bytes travel on
the host as the reference's host ring carries them); the engines run on
the card (``cuda:0`` for both ranks), or on the CPU with ``--cpu``.
Without ``--cpu`` and without a card it exits non-zero.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

N_REQUESTS = 12
ARRIVAL_RPS = 60.0
KILL_ROUND = 6
TRACE_SEED = 5
LOOP_KW = dict(block_size=8, n_blocks=64, max_batch=4, max_context=32,
               steps_per_round=2, prefill_per_round=2)


def _trace(cfg):
    from horovod_tpu_torch.serving.scheduler import poisson_trace

    return poisson_trace(N_REQUESTS, ARRIVAL_RPS, seed=TRACE_SEED,
                         prompt_len=(4, 12), max_new=(3, 8),
                         vocab_size=cfg.vocab_size)


def worker(device):
    import numpy as np
    import torch

    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.models import llama
    from horovod_tpu_torch.models.generate import llama_generate
    from horovod_tpu_torch.serving.engine import DecodeEngine
    from horovod_tpu_torch.serving.service import ServingLoop

    rank = int(os.environ["HOROVOD_RANK"])
    hvd.init(device="cpu")
    cfg = llama.LlamaConfig.tiny(dtype="float32", n_layers=2)
    params = llama.llama_init(cfg, torch.Generator(device=device)
                              .manual_seed(0), device=device)
    trace = _trace(cfg)

    def hook(loop, round_idx):
        if rank == 1 and round_idx == KILL_ROUND:
            # Die holding in-flight sequences.
            os.kill(os.getpid(), signal.SIGKILL)

    loop = ServingLoop(params, cfg, trace, quantized=True, round_hook=hook,
                       device=device, **LOOP_KW)
    report = loop.run()
    if hvd.rank() == 0:
        assert report["faults_survived"] >= 1, report
        assert report["served"] == len(trace), (report["served"], len(trace))
        one = DecodeEngine(params, cfg, quantized=True, device=device,
                           **{k: LOOP_KW[k] for k in (
                               "block_size", "n_blocks", "max_batch",
                               "max_context")})
        for req in trace:
            one.submit(req)
        want = one.run_until_idle()
        exact = 0
        for req in trace:
            got = report["completed"][req.rid]
            assert np.array_equal(got, want[req.rid]), (
                f"rid {req.rid}: served tokens diverge from one engine's"
                f"\n got {got}\n one {want[req.rid]}")
            ref = llama_generate(params, req.prompt[None, :], cfg,
                                 req.max_new_tokens, device=device)
            exact += bool(np.array_equal(got, ref[0].cpu().numpy()))
        summary = {k: report[k] for k in (
            "requests", "served", "generated_tokens", "faults_survived",
            "recoveries", "evictions", "rounds", "sustained_tok_s",
            "p50_ms", "p99_ms")}
        summary["equal_to_llama_generate"] = exact
        print("SERVE_SMOKE_OK " + json.dumps(summary), flush=True)
        _verify_request_chains(loop, report)
    hvd.shutdown()
    return 0


def _verify_request_chains(loop, report):
    """Dump the survivor's request events, stitch them, and assert every
    completed rid's chain is gap-free and reconciles to its wall time,
    with fault_requeue spans on exactly the re-queued rids."""
    from horovod_tpu_torch.telemetry import reqtrace

    dump_dir = os.environ["SERVE_SMOKE_DUMPS"]
    reqtrace.write_dump(os.path.join(dump_dir, "requests-rank0.json"), 0)
    chains = reqtrace.stitch(dump_dir)
    for rid in report["completed"]:
        chain = chains.get(int(rid))
        assert chain is not None, f"rid {rid}: no stitched chain"
        assert chain["complete"], f"rid {rid}: no terminal done"
        defects = reqtrace.chain_gaps(chain)
        assert not defects, f"rid {rid}: chain defects {defects}"
        assert sum(chain["phase_us"].values()) == chain["wall_us"], rid
    fault_rids = {rid for rid, c in chains.items()
                  if c["phase_us"].get("fault_requeue", 0) > 0}
    assert fault_rids == loop.requeued_rids, (
        "fault_requeue spans do not match the re-queued set",
        sorted(fault_rids), sorted(loop.requeued_rids))
    assert fault_rids, "the chaos fired but no request carries a " \
                       "fault_requeue span"
    print("REQTRACE_OK " + json.dumps({
        "chains": len(chains),
        "complete": sum(c["complete"] for c in chains.values()),
        "fault_requeued": sorted(fault_rids)}), flush=True)


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        return worker(argv[1])
    device = "cpu" if "--cpu" in argv else "cuda:0"
    if device != "cpu":
        import torch

        if not torch.cuda.is_available():
            print("serve_smoke: no CUDA device (use --cpu)", file=sys.stderr)
            return 2
    print(f"serve_smoke: engines on {device}, lane on gloo", flush=True)
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    dump_dir = tempfile.mkdtemp(prefix="serve_smoke_reqtrace_")
    procs = []
    for r in range(2):
        env = dict(os.environ)
        env.update({
            "HOROVOD_RANK": str(r), "HOROVOD_SIZE": "2",
            "HOROVOD_LOCAL_RANK": str(r), "HOROVOD_LOCAL_SIZE": "2",
            "HOROVOD_CONTROLLER_ADDR": "127.0.0.1",
            "HOROVOD_CONTROLLER_PORT": str(port),
            "HOROVOD_WIRE_TIMEOUT_MS": "2000",
            "SERVE_SMOKE_DUMPS": dump_dir,
            "PYTHONPATH": repo + os.pathsep + env.get("PYTHONPATH", ""),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "horovod_tpu_torch.serving.serve_smoke",
             "--worker", device],
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
            text=True, env=env, cwd=repo))
    t0 = time.monotonic()
    try:
        out, _ = procs[0].communicate(timeout=600)
        procs[1].wait(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ok = [ln for ln in out.splitlines() if ln.startswith("SERVE_SMOKE_OK")]
    assert procs[0].returncode == 0, f"rank 0 failed:\n{out}"
    assert ok, f"no SERVE_SMOKE_OK line:\n{out}"
    assert procs[1].returncode == -signal.SIGKILL, (
        "the victim exited cleanly: the chaos never fired "
        f"({procs[1].returncode})")
    summary = json.loads(ok[0].split(" ", 1)[1])
    assert summary["faults_survived"] >= 1, summary
    assert summary["served"] == summary["requests"] == N_REQUESTS
    traced = [ln for ln in out.splitlines() if ln.startswith("REQTRACE_OK")]
    assert traced, f"no REQTRACE_OK line:\n{out}"
    chains = json.loads(traced[0].split(" ", 1)[1])
    assert chains["complete"] == N_REQUESTS, chains
    print(f"serve_smoke OK in {time.monotonic() - t0:.1f}s: "
          f"{summary['served']}/{summary['requests']} requests "
          f"token-identical across a SIGKILLed decode rank to one "
          f"engine's ({summary['equal_to_llama_generate']} also to "
          f"llama_generate's) "
          f"({summary['generated_tokens']} tokens, p99 "
          f"{summary['p99_ms']:.0f} ms, {summary['faults_survived']} "
          f"fault(s) survived; {chains['complete']} gap-free request "
          f"chains, fault_requeue on {chains['fault_requeued']})",
          flush=True)
    # A failed run keeps its dumps (every assertion above raises first).
    shutil.rmtree(dump_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
