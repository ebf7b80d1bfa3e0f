"""The port's disaggregated serving loop (``serving/service.py``) on gloo
ranks, against the JAX package.

The tiny f32 Llama (``LlamaConfig.tiny(n_layers=2)``, JAX's params from
``PRNGKey(0)``), ``block_size=8``, ``n_blocks=64``, ``max_batch=4``,
``max_context=32`` and the trace of ``tests/parallel/
test_serving_elastic.py:34-55`` (8 requests at 120 rps, seed 9). Two
worlds of 3 ranks, started together, each serving the trace four times
(``RUNS``): whole, and with its last decode rank SIGKILLed at round 5,
at 3 ranks and then at the 2 the first kill leaves, int8 and f32 KV, so
that every pairing of world size (3, 2), kill and KV format runs. In
every run every request completes (on the survivors after a kill, the
victims' exits SIGKILLs), and its tokens equal:

- at f32 KV, JAX's ``llama_generate`` on the same params;
- at int8 KV, JAX's ``DecodeEngine`` serving the trace in one process
  with the same int8 pool. JAX's own int8 kill test holds them to
  ``llama_generate`` and fails (rid 3's last token: ROADMAP.md queue
  C); the int8 pool moves that near-tie, in both packages alike.

The survivors' request events stitch (``telemetry/reqtrace.py``) into
one gap-free chain per request, the phase sums equal to the wall time,
with ``fault_requeue`` on exactly the re-queued rids. Mid-run,
``/healthz`` carries the serving fields of ``SERVING_SIGNAL_DEFAULTS``
(JAX's) with the live pool's values and ``/requests`` lists live rids;
after the run the fields are back at their sentinels. In one process:
``write_raw``/``read_raw`` adopt and return JAX's ``quantize_blocks``
bytes, and ``Sequence.length``, ``adopt``, ``drop`` and the signal
counters match JAX's scheduler.
"""

import json
import os
import signal
import tempfile
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.models import LlamaConfig as JaxConfig
from horovod_tpu.models import llama_generate, llama_init
from horovod_tpu.serving import engine as jengine
from horovod_tpu.serving import kvcache as jkv
from horovod_tpu.serving import scheduler as jsched
from horovod_tpu.telemetry.autoscale import SERVING_SIGNAL_DEFAULTS
from horovod_tpu.telemetry.reqtrace import REQUEST_PHASES
from tests.test_torch_elastic_ranks import run_chaos

N_REQUESTS = 8
RPS = 120.0
TRACE_SEED = 9
KILL_ROUND = 5
LOOP_KW = dict(block_size=8, n_blocks=64, max_batch=4, max_context=32,
               steps_per_round=2, prefill_per_round=2)
# Each world's runs: (KV format, the rank SIGKILLed at KILL_ROUND or None).
RUNS = [[("int8", None), ("f32", None), ("int8", 2), ("f32", 1)],
        [("f32", 2), ("int8", None), ("f32", None), ("int8", 1)]]
SIZE = 3


def _trace(vocab):
    from horovod_tpu_torch.serving.scheduler import poisson_trace

    return poisson_trace(N_REQUESTS, RPS, seed=TRACE_SEED,
                         prompt_len=(4, 10), max_new=(3, 7),
                         vocab_size=vocab)


def _jax_params():
    jc = JaxConfig.tiny(dtype="float32", n_layers=2)
    return jc, llama_init(jc, jax.random.PRNGKey(0))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return json.loads(r.read())


def _serve(rank, size):
    """The world's runs of the trace (``RUNS``), in order."""
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import events
    from horovod_tpu_torch.models.convert import from_jax_params
    from horovod_tpu_torch.models.llama import LlamaConfig
    from horovod_tpu_torch.serving.service import ServingLoop, serving_signals
    from horovod_tpu_torch.telemetry import reqtrace

    runs = RUNS[int(os.environ["SERVE_WORLD"])]
    hvd.init(device="cpu")
    cfg = LlamaConfig.tiny(dtype="float32", n_layers=2)
    with np.load(os.environ["SERVE_PARAMS"]) as f:
        params = from_jax_params(_unflat(dict(f)), device="cpu")
    trace = _trace(cfg.vocab_size)
    out = {"runs": []}
    live = {}

    for run, (kind, victim) in enumerate(runs):
        def hook(loop, round_idx, victim=victim, run=run):
            if victim is not None and round_idx == KILL_ROUND and \
                    hvd.rank() == victim:
                os.kill(os.getpid(), signal.SIGKILL)
            if run == 0 and hvd.rank() == 0 and not live and \
                    loop._assigned:
                # The first round with requests in flight.
                port = hvd.debug_port()
                live["healthz"] = _get(port, "/healthz")
                live["requests"] = _get(port, "/requests?n=0")
                live["signals"] = serving_signals()

        events.RING.reset()
        size_before = hvd.size()
        loop = ServingLoop(params, cfg, trace, quantized=kind == "int8",
                           round_hook=hook, device="cpu", **LOOP_KW)
        t0 = time.monotonic()
        report = loop.run()
        secs = time.monotonic() - t0
        reqtrace.write_dump(os.path.join(
            os.environ["SERVE_DUMPS"], f"run{run}-rank{hvd.rank()}.json"),
            hvd.rank())
        if hvd.rank() == 0:
            out["runs"].append({
                "kind": kind, "size": size_before, "size_after": hvd.size(),
                "requeued": sorted(loop.requeued_rids),
                "completed": {int(k): v.tolist() for k, v in
                              report["completed"].items()},
                "seconds": secs,
                **{k: report[k] for k in ("served", "faults_survived")}})
    if rank == 0:
        port = hvd.debug_port()
        out["after"] = {"healthz": _get(port, "/healthz"),
                        "requests": _get(port, "/requests?n=0")}
        out["live"] = live
    hvd.shutdown()
    return out


@pytest.fixture(scope="module")
def jax_side():
    jc, jp = _jax_params()
    trace = _trace(jc.vocab_size)
    gen = {r.rid: np.asarray(llama_generate(
        jp, jnp.asarray(r.prompt[None, :]), jc, r.max_new_tokens))[0]
        for r in trace}
    eng = jengine.DecodeEngine(jp, jc, quantized=True, **{
        k: LOOP_KW[k] for k in ("block_size", "n_blocks", "max_batch",
                                "max_context")})
    for r in trace:
        eng.submit(r)
    return {"f32": gen, "int8": eng.run_until_idle(), "params": jp}


@pytest.fixture(scope="module")
def worlds(jax_side, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "params.npz")
    np.savez(path, **_flat(jax.tree.map(np.asarray, jax_side["params"])))
    results, errors = [None] * len(RUNS), []

    def one(i):
        env = {"SERVE_PARAMS": path, "SERVE_WORLD": str(i),
               "SERVE_DUMPS": tempfile.mkdtemp(prefix="serve_loop_"),
               "HOROVOD_DEBUG_PORT": "0"}
        try:
            ranks, _ = run_chaos(_serve, SIZE, victims={1, 2}, timeout=240,
                                 env=env)
            results[i] = (ranks[0], env["SERVE_DUMPS"])
        except BaseException as e:  # noqa: BLE001: re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(RUNS))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


CASES = [(w, r) for w in range(len(RUNS)) for r in range(len(RUNS[w]))]


def _case_id(case):
    kind, victim = RUNS[case[0]][case[1]]
    return f"world{case[0]}-run{case[1]}-{kind}-" + (
        "whole" if victim is None else f"kill{victim}")


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_every_request_served_token_identical(worlds, jax_side, case):
    world, run = case
    kind, victim = RUNS[world][run]
    got = worlds[world][0]["runs"][run]
    assert got["kind"] == kind and got["served"] == N_REQUESTS
    assert got["faults_survived"] == (victim is not None)
    assert got["size_after"] == got["size"] - (victim is not None)
    want = jax_side[kind]
    for rid in range(N_REQUESTS):
        np.testing.assert_array_equal(got["completed"][rid], want[rid],
                                      err_msg=f"rid {rid}")
    if victim is not None:
        assert got["requeued"], "the kill re-queued nothing"


KILLS = [c for c in CASES if RUNS[c[0]][c[1]][1] is not None]


@pytest.mark.parametrize("case", KILLS, ids=[_case_id(c) for c in KILLS])
def test_request_chains_stitch_gap_free(worlds, case):
    from horovod_tpu_torch.telemetry import reqtrace

    world, run = case
    out, dumps = worlds[world]
    paths = [os.path.join(dumps, n) for n in os.listdir(dumps)
             if n.startswith(f"run{run}-")]
    chains = reqtrace.stitch(paths)
    assert sorted(chains) == list(range(N_REQUESTS))
    for rid, chain in chains.items():
        assert chain["complete"], rid
        assert not reqtrace.chain_gaps(chain), rid
        assert sum(chain["phase_us"].values()) == chain["wall_us"]
    fault = sorted(rid for rid, c in chains.items()
                   if c["phase_us"].get("fault_requeue", 0) > 0)
    assert fault == out["runs"][run]["requeued"]
    if out["runs"][run]["size"] == 3:
        # The surviving decode rank's spans are in the chains.
        assert any(1 in c["ranks"] for c in chains.values())


def test_healthz_serving_fields_and_live_requests(worlds):
    out = worlds[0][0]
    health, rows = out["live"]["healthz"], out["live"]["requests"]
    assert set(SERVING_SIGNAL_DEFAULTS) <= set(health)
    assert health["kv_blocks_total"] == LOOP_KW["n_blocks"]
    assert {k: health[k] for k in SERVING_SIGNAL_DEFAULTS} != \
        SERVING_SIGNAL_DEFAULTS
    assert set(out["live"]["signals"]) == set(SERVING_SIGNAL_DEFAULTS)
    assert rows and all(r["phase"] in REQUEST_PHASES for r in rows)
    assert {r["rid"] for r in rows} <= set(range(N_REQUESTS))
    after = out["after"]
    assert {k: after["healthz"][k] for k in SERVING_SIGNAL_DEFAULTS} == \
        SERVING_SIGNAL_DEFAULTS
    assert after["requests"] == []


@pytest.mark.parametrize("quantized", [True, False])
def test_raw_blocks_round_trip_jax_quantize_blocks(quantized):
    from horovod_tpu_torch.serving import kvcache as tkv

    rng = np.random.default_rng(5)
    k = (rng.standard_normal((2, 3, 19, 8)) * 3).astype(np.float32)
    v = rng.standard_normal((2, 3, 19, 8)).astype(np.float32)
    k_q, v_q, k_s, v_s = jkv.quantize_blocks(k, v, 8, quantized=quantized)
    pool = tkv.PagedKVCache(2, 3, 8, block_size=8, n_blocks=7,
                            quantized=quantized)
    jpool = jkv.PagedKVCache(2, 3, 8, block_size=8, n_blocks=7,
                             quantized=quantized)
    blocks = pool.alloc(3)
    assert blocks == jpool.alloc(3)
    pool.write_raw(blocks, k_q, v_q, k_s, v_s)
    jpool.write_raw(blocks, k_q, v_q, k_s, v_s)
    got, want = pool.read_raw(blocks), jpool.read_raw(blocks)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert g.numpy().tobytes() == np.asarray(w).tobytes()
    for g, w in zip(pool.gather(blocks, 1), jpool.gather(blocks, 1)):
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), w)


def _scheduler_log(mod, kv):
    pool = kv.PagedKVCache(1, 1, 4, block_size=4, n_blocks=8)
    sched = mod.ContinuousBatchingScheduler(pool, max_batch=3,
                                            token_budget=60)
    log = []
    reqs = [mod.Request(rid=i, prompt=np.zeros(5 + i, np.int32),
                        max_new_tokens=4) for i in range(4)]
    for r in reqs[:2]:
        sched.submit(r)
    (a, b) = sched.admit()
    remote = mod.Sequence(req=reqs[2], blocks=pool.alloc(2), generated=[7])
    log.append(("length", remote.length, remote.cached))
    sched.adopt(remote)
    sched.submit(reqs[3])
    log.append(("drop", sched.drop(2), sched.drop(3), sched.drop(9)))
    log.append(("running", [s.rid for s in sched.running],
                [r.rid for r in sched.waiting], pool.blocks_free))
    a.generated = [1, 2, 3, 4]
    sched.complete(a)
    sched.evict(b)
    log.append(("signals", sched.signals()))
    return log


def test_scheduler_adopt_drop_and_counters_match_jax():
    from horovod_tpu_torch.serving import kvcache as tkv
    from horovod_tpu_torch.serving import scheduler as tsched

    assert _scheduler_log(tsched, tkv) == _scheduler_log(jsched, jkv)
