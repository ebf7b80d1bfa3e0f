"""Continuous-batching request scheduler: admit/evict per decode step.

The port's own copy of horovod_tpu/serving/scheduler.py, with its
request-tracing transitions (``telemetry/reqtrace.py``) and the
multi-rank service's hooks (:meth:`ContinuousBatchingScheduler.adopt`,
:meth:`ContinuousBatchingScheduler.drop`). Pure
bookkeeping: requests wait in arrival order; each step the scheduler
admits from the front while batch slots, the token budget (sum of live
context lengths) and pool blocks for prompt+1 hold, and grows running
sequences one block at a time. When the pool runs dry the YOUNGEST
running sequence is evicted and its request re-queued at the front for
a later re-prefill; greedy decoding makes that replay token-identical.

Prompts stay numpy int32 arrays: host-side control-plane data, and the
same arrays the JAX copy takes, so one trace drives both packages.
"""

from collections import deque
from dataclasses import dataclass, field

import numpy as np

from horovod_tpu_torch.serving.kvcache import OutOfBlocks
from horovod_tpu_torch.telemetry import reqtrace


@dataclass
class Request:
    """One decode request (prompt tokens in, greedy continuation out)."""

    rid: int
    prompt: np.ndarray            # [T] int32
    max_new_tokens: int
    arrival_t: float = 0.0        # seconds on the trace clock


@dataclass
class Sequence:
    """A running request: its block table and generated tail."""

    req: Request
    blocks: list = field(default_factory=list)
    generated: list = field(default_factory=list)  # incl. the prefill's
    #                                                first token

    @property
    def rid(self):
        return self.req.rid

    @property
    def length(self):
        """Logical sequence length (prompt + generated so far)."""
        return len(self.req.prompt) + len(self.generated)

    @property
    def cached(self):
        """Cache slots holding K/V: the newest generated token is the
        decode step's input, whose K/V that step writes at ``cached``,
        so this stays one behind prompt + generated while decoding."""
        return len(self.req.prompt) + max(len(self.generated) - 1, 0)

    @property
    def done(self):
        return len(self.generated) >= self.req.max_new_tokens

    @property
    def tokens(self):
        return np.concatenate([
            np.asarray(self.req.prompt, np.int32),
            np.asarray(self.generated, np.int32)])


def poisson_trace(n, rps, seed=0, prompt_len=(4, 24),
                  max_new=(4, 24), vocab_size=256):
    """A deterministic Poisson arrival trace: ``n`` requests with
    exponential inter-arrival gaps at ``rps`` requests/second, ragged
    prompt lengths and generation budgets (numpy's generator, so the
    JAX copy draws the same trace from the same seed)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n):
        t += rng.exponential(1.0 / rps)
        tlen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        out.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, size=tlen).astype(np.int32),
            max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
            arrival_t=t))
    return out


class ContinuousBatchingScheduler:
    """Admit/evict against a :class:`PagedKVCache` and a token budget.

    ``token_budget`` caps the sum of live context lengths across
    running sequences; ``max_batch`` caps batch slots (the decode
    step's static B).
    """

    def __init__(self, pool, max_batch=8, token_budget=4096):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.token_budget = int(token_budget)
        self.waiting = deque()
        self.running = []            # admission order: oldest first
        self.completed = {}          # rid -> Sequence
        self.evictions = 0
        # Eviction amplification: prompt tokens prefilled again because
        # their first pass was thrown away, against generated tokens
        # that reached a completion.
        self.recomputed_prefill_tokens = 0
        self.useful_tokens = 0

    # ---- signals -------------------------------------------------------

    @property
    def queue_depth(self):
        return len(self.waiting)

    @property
    def inflight(self):
        return len(self.running)

    def _live_tokens(self):
        # +1: each running sequence is about to fill one more slot.
        return sum(s.cached + 1 for s in self.running)

    # ---- admission -----------------------------------------------------

    def submit(self, req):
        reqtrace.record_request("queued", req.rid, aux=len(req.prompt))
        self.waiting.append(req)

    def requeue_front(self, reqs):
        """Put evicted requests back at the head of the line."""
        for r in reversed(list(reqs)):
            self.waiting.appendleft(r)

    def admit(self):
        """Admit from the waiting queue while every budget holds.
        Returns the newly admitted :class:`Sequence` list; the caller
        prefills them and writes their KV blocks."""
        admitted = []
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            need_tokens = len(req.prompt) + 1
            if self._live_tokens() + need_tokens > self.token_budget:
                break
            try:
                blocks = self.pool.alloc(self.pool.blocks_for(need_tokens))
            except OutOfBlocks:
                break
            self.waiting.popleft()
            seq = Sequence(req=req, blocks=blocks)
            self.running.append(seq)
            admitted.append(seq)
        return admitted

    def adopt(self, seq):
        """Register a sequence built elsewhere (the disaggregated path:
        prefilled on another rank, its blocks allocated and written)."""
        self.running.append(seq)

    # ---- per-step growth / eviction ------------------------------------

    def ensure_slot(self, seq):
        """Guarantee ``seq`` a cache slot for its next token, growing its
        block table across a block boundary and evicting the youngest
        OTHER running sequence until the allocation fits. Returns False
        when ``seq`` itself had to be evicted."""
        need = self.pool.blocks_for(seq.cached + 1)
        while need > len(seq.blocks):
            try:
                seq.blocks.extend(self.pool.alloc(need - len(seq.blocks)))
            except OutOfBlocks:
                victim = self._youngest_other(seq)
                if victim is None:
                    self.evict(seq)
                    return False
                self.evict(victim)
        return True

    def _youngest_other(self, seq):
        for s in reversed(self.running):
            if s is not seq:
                return s
        return None

    def evict(self, seq):
        """Free a running sequence's blocks and re-queue its request at
        the front (re-prefilled later, token-identically)."""
        self.running.remove(seq)
        self.pool.free(seq.blocks)
        seq.blocks = []
        seq.generated = []
        self.requeue_front([seq.req])
        self.evictions += 1
        self.recomputed_prefill_tokens += len(seq.req.prompt)
        reqtrace.record_request("evicted_requeue", seq.rid,
                                aux=len(seq.req.prompt))

    def complete(self, seq):
        self.running.remove(seq)
        self.pool.free(seq.blocks)
        seq.blocks = []
        self.completed[seq.rid] = seq
        self.useful_tokens += len(seq.generated)
        reqtrace.record_request("done", seq.rid, aux=len(seq.generated))

    def drop(self, rid):
        """Cancel a running or waiting request (the elastic duplicate
        guard: another rank completed it). True when one was dropped.
        No ``done`` transition: the winning completion's is the chain's
        terminal; only the live table forgets the rid."""
        for s in list(self.running):
            if s.rid == rid:
                self.running.remove(s)
                self.pool.free(s.blocks)
                s.blocks = []
                reqtrace.forget_request(rid)
                return True
        for r in list(self.waiting):
            if r.rid == rid:
                self.waiting.remove(r)
                reqtrace.forget_request(rid)
                return True
        return False

    def signals(self):
        """The serving signal set (queue, pool, amplification)."""
        out = {"serving_queue_depth": self.queue_depth,
               "inflight_sequences": self.inflight,
               "recomputed_prefill_tokens":
                   self.recomputed_prefill_tokens,
               "useful_tokens": self.useful_tokens,
               "eviction_amplification": round(
                   self.recomputed_prefill_tokens
                   / max(self.useful_tokens, 1), 6)}
        out.update(self.pool.stats())
        return out


def latency_summary(latencies_s):
    """p50/p99 (ms) over per-request completion latencies."""
    if not latencies_s:
        return {"p50_ms": 0.0, "p99_ms": 0.0}
    p50, p99 = np.percentile(np.asarray(latencies_s, np.float64),
                             [50, 99])
    return {"p50_ms": round(float(p50) * 1000.0, 3),
            "p99_ms": round(float(p99) * 1000.0, 3)}
