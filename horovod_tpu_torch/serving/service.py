"""The elastic serving loop: prefill/decode disaggregation.

The port's own copy of ``horovod_tpu/serving/service.py``. Rank 0 is the
FRONTEND: it owns the arrival trace, prefills on its card and keeps the
scoreboard of completions; every other rank is a DECODE rank running a
local :class:`DecodeEngine` on its card. At size 1 the frontend decodes
too (all in one, which a 2-rank world collapses to when its decode rank
dies). The topology is derived every round, so a resize just works.

One round is one lockstep beat of the world:

1. the frontend admits due arrivals, prefills (``llama_prefill``: K1 on
   the card) and packs each prompt's KV into POOL-FORMAT blocks, int8
   with per-block scales when quantized, so the wire ships the narrow
   format and a decode rank adopts the bytes verbatim (``write_raw``):
   quantized once, at the source;
2. a control allgather (``common/elastic._allgather_object``: pickled,
   over the lane's gloo side): frontend -> assignments, cancels,
   shutdown; decode ranks -> acks, rejects, completions, stats;
3. one host ``uint8`` alltoall on the lane's gloo side ships the KV
   payloads to their ranks, the splits routing them (skipped by
   agreement when nothing was assigned);
4. decode ranks adopt new sequences and run ``steps_per_round``
   continuous-batching steps on their cards (the step's attention is
   ``decode_attention_ragged``, the plain chain, as in the JAX package);
   the frontend decodes its own batch when it is in the decode set.

A typed collective failure at the round boundary (a SIGKILLed decode
rank's ``HorovodPeerFailureError``) re-forms the world in place
(``hvd.elastic.reset``: every survivor's pool and running batch survive)
and the frontend re-queues the dead rank's in-flight requests and
anything assigned but never acked. Greedy decoding at the engine's
static shapes makes the replay token-identical. A re-queued rid that a
survivor also still holds is cancelled there through the control
message: the first completion wins.

``/healthz`` carries the serving fields of :func:`serving_signals`
(``telemetry/autoscale.py SERVING_SIGNAL_DEFAULTS`` when no loop is
live); every lifecycle transition is a ``request`` event
(``telemetry/reqtrace.py``), and ``/requests`` lists the live rids.
"""

import time
from collections import deque

import numpy as np
import torch

from horovod_tpu_torch.serving.engine import DecodeEngine
from horovod_tpu_torch.serving.kvcache import OutOfBlocks, quantize_blocks
from horovod_tpu_torch.serving.scheduler import (
    Request,
    Sequence,
    latency_summary,
)
from horovod_tpu_torch.telemetry import reqtrace
from horovod_tpu_torch.telemetry.autoscale import SERVING_SIGNAL_DEFAULTS

# The live loop of this process (serving_signals, /healthz).
_live = None


def serving_signals():
    """The ``/healthz`` serving fields: the live loop's, else the
    sentinels."""
    if _live is not None:
        try:
            return _live.signals()
        except Exception:  # noqa: BLE001: the health check must answer
            pass
    return dict(SERVING_SIGNAL_DEFAULTS)


def _to_bytes(t):
    """A tensor's bytes (its dtype's layout, bf16 included)."""
    return t.detach().contiguous().cpu().reshape(-1).view(
        torch.uint8).numpy().tobytes()


def _from_bytes(buf, offset, dtype, shape):
    """The tensor of ``shape``/``dtype`` at ``offset`` of ``buf`` (a
    writable buffer), and the offset after it."""
    n = int(np.prod(shape)) * dtype.itemsize
    t = torch.frombuffer(buf, dtype=torch.uint8, count=n, offset=offset)
    return t.view(dtype).reshape(shape).clone(), offset + n


class _World:
    """The lane's rank, size and epoch (a world of one when no lane is
    open)."""

    def __init__(self):
        from horovod_tpu_torch.common import basics

        self._b = basics

    def rank(self):
        return self._b.rank() if self._b.is_initialized() else 0

    def size(self):
        return self._b.size() if self._b.is_initialized() else 1

    def epoch(self):
        return self._b.epoch() if self._b.is_initialized() else 0


class ServingLoop:
    """Round-based elastic serving over a request trace.

    ``trace`` is a list of :class:`Request` (``poisson_trace``); arrival
    times are honoured against a wall clock started at :meth:`run`
    (``time_scale`` < 1 compresses them). ``round_hook(loop, round)``
    runs at the top of every round on every rank (the chaos tests' kill
    point). ``device`` is where this rank's engine runs (None: the card,
    as ``DecodeEngine``'s)."""

    def __init__(self, params, config, trace=(), *, block_size=16,
                 n_blocks=256, max_batch=8, max_context=512,
                 token_budget=None, quantized=False, steps_per_round=4,
                 prefill_per_round=4, max_rounds=100000,
                 time_scale=1.0, round_hook=None, device=None):
        self.engine = DecodeEngine(
            params, config, block_size=block_size, n_blocks=n_blocks,
            max_batch=max_batch, max_context=max_context,
            token_budget=token_budget, quantized=quantized, device=device)
        self.params = params
        self.config = config
        self.trace = sorted(trace, key=lambda r: r.arrival_t)
        self.quantized = bool(quantized)
        self.steps_per_round = int(steps_per_round)
        self.prefill_per_round = int(prefill_per_round)
        self.max_rounds = int(max_rounds)
        self.time_scale = float(time_scale)
        self.round_hook = round_hook
        # Every request must fit the engine's static decode shape: reject
        # here, not in a decode rank's gather (where it reads as a fault).
        for req in self.trace:
            if len(req.prompt) + req.max_new_tokens > self.engine.s_pad:
                raise ValueError(
                    f"request {req.rid}: prompt {len(req.prompt)} + "
                    f"max_new {req.max_new_tokens} exceeds max_context "
                    f"{self.engine.s_pad}")
        # Frontend state.
        self._pending = []            # Requests awaiting assignment
        self._assigned = {}           # rid -> {req, rank, acked}
        self._cancel = []             # rids to cancel on survivors
        self._completed = {}          # rid -> np.ndarray tokens
        self._latency = {}            # rid -> seconds
        # The newest completions' latencies: /healthz's p50/p99 describe
        # current pressure, not the whole run's history.
        self._lat_window = deque(maxlen=128)
        self.requests_served = 0
        self.requeued_rids = set()    # re-queued after a peer fault
        self._req_by_rid = {r.rid: r for r in self.trace}
        self._arrival_idx = 0
        # Decode-rank outboxes: a report stays until the frontend provably
        # applied it (its next round's control is the proof), so items go
        # sent -> inflight -> retired; a fault keeps them for re-send and
        # the frontend's handlers are idempotent.
        self._ack_buf = []
        self._reject_buf = []
        self._done_outbox = {}
        self._inflight = {"acks": [], "rejects": [], "done": []}
        self.faults_survived = 0
        self.recoveries = []          # (round, seconds) of each re-formation
        self.served_local = 0         # completions this rank decoded
        self.rounds = 0
        # Collectives are named serve.<epoch>.<epoch_round>; the counter
        # resets on recovery, so survivors that saw the fault at
        # different rounds re-align at (new epoch, 0).
        self._epoch_round = 0
        self._rr = 0                  # round-robin assignment cursor

    # ---- signals -------------------------------------------------------

    def signals(self):
        sig = self.engine.scheduler.signals()
        sig["serving_queue_depth"] += len(self._pending)
        # Latency is measured where the arrival clock lives (the
        # frontend); a decode rank's served count is what it decoded.
        lat = latency_summary(list(self._lat_window))
        sig["serving_p50_ms"] = lat["p50_ms"]
        sig["serving_p99_ms"] = lat["p99_ms"]
        sig["requests_served"] = self.requests_served or self.served_local
        return sig

    # ---- helpers -------------------------------------------------------

    def _decode_ranks(self, size):
        return list(range(1, size)) if size > 1 else [0]

    def _pack_assignment(self, req):
        """Prefill one request and freeze its wire payload: pool-format
        blocks (quantized at the source for an int8 pool) and the
        metadata a decode rank needs to adopt them."""
        reqtrace.record_request("prefill", req.rid, aux=len(req.prompt))
        first, k, v = self.engine.prefill(req)
        k_q, v_q, k_s, v_s = quantize_blocks(
            k, v, self.engine.pool.block_size, quantized=self.quantized,
            dtype=self.engine.pool.k_pool.dtype)
        payload = [_to_bytes(k_q), _to_bytes(v_q)]
        if self.quantized:
            payload += [_to_bytes(k_s), _to_bytes(v_s)]
        meta = {"rid": req.rid,
                "prompt": np.asarray(req.prompt, np.int32).tolist(),
                "first": int(first), "max_new": int(req.max_new_tokens),
                "n_blocks": int(k_q.shape[0]),
                "nbytes": sum(len(p) for p in payload)}
        # In flight to its decode rank until that rank adopts it (or,
        # if the rank dies holding it, until fault_requeue).
        reqtrace.record_request("kv_ship", req.rid, aux=meta["nbytes"])
        return meta, b"".join(payload)

    def _adopt_assignment(self, meta, payload):
        """A decode rank's side of :meth:`_pack_assignment`: allocate
        local blocks, adopt the shipped bytes, register the sequence.
        False when the local pool is full (a NACK)."""
        pool = self.engine.pool
        c = self.config
        n = meta["n_blocks"]
        shape = (n, c.n_layers, c.n_kv_heads, pool.block_size, c.head_dim)
        buf = bytearray(payload)
        k_q, off = _from_bytes(buf, 0, pool.k_pool.dtype, shape)
        v_q, off = _from_bytes(buf, off, pool.k_pool.dtype, shape)
        k_s = v_s = None
        if self.quantized:
            k_s, off = _from_bytes(buf, off, torch.float32, shape[:3])
            v_s, off = _from_bytes(buf, off, torch.float32, shape[:3])
        try:
            blocks = pool.alloc(n)
        except OutOfBlocks:
            return False
        pool.write_raw(blocks, k_q, v_q, k_s, v_s)
        req = Request(rid=meta["rid"],
                      prompt=np.asarray(meta["prompt"], np.int32),
                      max_new_tokens=meta["max_new"])
        seq = Sequence(req=req, blocks=blocks, generated=[meta["first"]])
        if seq.done:  # max_new == 1: the prefill's token finished it
            pool.free(blocks)
            seq.blocks = []
            self.engine.scheduler.completed[seq.rid] = seq
            self.engine.scheduler.useful_tokens += len(seq.generated)
            reqtrace.record_request("done", seq.rid, aux=len(seq.generated))
        else:
            self.engine.adopt_remote(seq)
        return True

    def _admit_arrivals(self, now):
        while (self._arrival_idx < len(self.trace)
               and self.trace[self._arrival_idx].arrival_t
               * self.time_scale <= now):
            req = self.trace[self._arrival_idx]
            reqtrace.record_request("queued", req.rid, aux=len(req.prompt))
            self._pending.append(req)
            self._arrival_idx += 1

    # ---- fault recovery ------------------------------------------------

    def _recover(self, old_size, old_rank):
        """Re-form over the survivors and re-route orphaned work."""
        from horovod_tpu_torch.common import elastic as hvd_elastic

        alive = hvd_elastic.survivors()   # old ranks, rank-consistent
        if old_rank != 0 and alive is not None and 0 not in alive:
            # The frontend owns the scoreboard; no survivor can rebuild
            # it, and a decode rank promoted to rank 0 would replay the
            # trace against its own half-decoded state.
            raise RuntimeError(
                "frontend (rank 0) died; the serving loop cannot re-form "
                "without its scoreboard: restart the service")
        hvd_elastic.reset()
        self.faults_survived += 1
        self._epoch_round = 0
        self._inflight = {"acks": [], "rejects": [], "done": []}
        if old_rank == 0:
            if alive is None:
                # No agreed dead set (the full re-init fallback): every
                # un-acked or remote assignment counts as orphaned.
                alive = [0]
            dead = [r for r in range(old_size) if r not in alive]
            requeue = []
            for rid, rec in list(self._assigned.items()):
                target = rec["rank"]
                if target in dead or not rec["acked"]:
                    requeue.append(rec["req"])
                    if target not in dead:
                        # Possibly admitted with the ack lost in the
                        # dying round: cancel the survivor's copy.
                        self._cancel.append(rid)
                    del self._assigned[rid]
                else:
                    rec["rank"] = alive.index(target)
            requeue.sort(key=lambda r: r.arrival_t)
            for req in requeue:
                # The orphan's extra latency books to fault_requeue until
                # its replacement prefill starts; its prefill is redone.
                reqtrace.record_request("fault_requeue", req.rid,
                                        aux=len(req.prompt))
                self.requeued_rids.add(req.rid)
                self.engine.scheduler.recomputed_prefill_tokens += \
                    len(req.prompt)
            self._pending = requeue + self._pending
        return self._world.rank(), self._world.size()

    # ---- the loop ------------------------------------------------------

    def run(self):
        """Drive the trace to completion. Rank 0 returns the serving
        report (completions, latency percentiles, sustained tok/s);
        decode ranks return their engine's stats."""
        global _live
        from horovod_tpu_torch.common.exceptions import HorovodInternalError

        self._world = w = _World()
        _live = self
        t0 = time.monotonic()
        try:
            while True:
                rank, size = w.rank(), w.size()
                if self.round_hook is not None:
                    self.round_hook(self, self.rounds)
                try:
                    done = self._round(rank, size, time.monotonic() - t0)
                except HorovodInternalError:
                    t_fault = time.monotonic()
                    self._recover(size, rank)
                    self.recoveries.append(
                        (self.rounds, time.monotonic() - t_fault))
                    continue
                self.rounds += 1
                self._epoch_round += 1
                if done:
                    break
                if self.rounds > self.max_rounds:
                    raise RuntimeError(
                        f"serving loop: no convergence after "
                        f"{self.max_rounds} rounds")
            decode_clock = time.monotonic() - t0
        finally:
            _live = None
        if w.rank() != 0:
            return {"rank": w.rank(), "steps": self.engine.steps,
                    "served": self.served_local,
                    "evictions": self.engine.scheduler.evictions}
        total_tokens = int(sum(
            len(t) - len(self._req_by_rid[rid].prompt)
            for rid, t in self._completed.items()))
        lat = latency_summary(list(self._latency.values()))
        return {
            "completed": {int(r): np.asarray(t)
                          for r, t in self._completed.items()},
            "latency_s": dict(self._latency),
            "requests": len(self.trace),
            "served": len(self._completed),
            "generated_tokens": total_tokens,
            "wall_s": round(decode_clock, 4),
            "sustained_tok_s": round(total_tokens / decode_clock, 2)
            if decode_clock > 0 else 0.0,
            "faults_survived": self.faults_survived,
            "recoveries": list(self.recoveries),
            "evictions": self.engine.scheduler.evictions,
            "rounds": self.rounds,
            **lat,
        }

    def _score_completion(self, rid, now, remote=False):
        """The frontend's scoreboard entry of a completed rid: its
        latency, the rolling window, and the chain's terminal ``done``
        (the instant the answer exists). ``remote`` books the generated
        tokens as useful on the frontend's scheduler too, so that its
        amplification ratio describes the service."""
        lat = max(now - self._req_by_rid[rid].arrival_t * self.time_scale,
                  0.0)
        self._latency[rid] = lat
        self._lat_window.append(lat)
        self.requests_served += 1
        generated = len(self._completed[rid]) - len(
            self._req_by_rid[rid].prompt)
        if remote:
            self.engine.scheduler.useful_tokens += generated
        reqtrace.record_request("done", rid, aux=generated)

    def _round(self, rank, size, now):
        from horovod_tpu_torch.common import elastic as hvd_elastic

        tag = f"serve.{self._world.epoch()}.{self._epoch_round}"
        decode_ranks = self._decode_ranks(size)

        # -- frontend: admit, prefill, assign ---------------------------
        packed = {}                   # target rank -> [(meta, bytes)]
        if rank == 0:
            self._admit_arrivals(now)
            if size == 1:
                for req in self._pending:
                    self.engine.submit(req)
                self._pending = []
            assigns = []
            if size > 1:
                budget = self.prefill_per_round
                while self._pending and budget > 0:
                    req = self._pending.pop(0)
                    target = decode_ranks[self._rr % len(decode_ranks)]
                    self._rr += 1
                    meta, payload = self._pack_assignment(req)
                    meta["target"] = target
                    packed.setdefault(target, []).append((meta, payload))
                    assigns.append(meta)
                    self._assigned[req.rid] = {
                        "req": req, "rank": target, "acked": False}
                    budget -= 1
            all_done = (self._arrival_idx >= len(self.trace)
                        and not self._pending and not self._assigned
                        and (size > 1 or (
                            not self.engine.scheduler.waiting
                            and not self.engine.scheduler.running)))
            ctl = {"assign": assigns, "cancel": list(self._cancel),
                   "shutdown": bool(all_done)}
        else:
            ctl = {"acks": list(self._ack_buf),
                   "rejects": list(self._reject_buf),
                   "done": self._done_out(),
                   "stats": self.engine.scheduler.signals()}

        # -- the collectives: the only fault surface ---------------------
        if size > 1:
            ctls = hvd_elastic._allgather_object(ctl, name=f"{tag}.ctl")
            front = ctls[0]
            if rank != 0:
                self._retire_inflight(ctl)
        else:
            front, ctls = ctl, [ctl]

        # Cancels before this round's adoptions: they target copies of
        # earlier rounds, and a rid cancelled and re-assigned in one
        # control message keeps its fresh copy.
        if rank in decode_ranks:
            for rid in front.get("cancel", ()):
                self.engine.scheduler.drop(rid)
        if size > 1 and front["assign"]:
            self._exchange_payloads(rank, size, front, packed, tag)

        # -- apply control -----------------------------------------------
        if rank == 0 and size > 1:
            for peer_rank, peer in enumerate(ctls[1:], start=1):
                self._apply_decode_report(peer_rank, peer, now)
        if rank == 0:
            # Retire only the cancels that rode this round's control;
            # the reports may have added fresh ones.
            sent = set(ctl["cancel"])
            self._cancel = [c for c in self._cancel if c not in sent]
        if rank in decode_ranks:
            for _ in range(self.steps_per_round):
                self.engine.step()
        if rank == 0 and size == 1:
            for rid, seq in list(self.engine.scheduler.completed.items()):
                if rid not in self._completed:
                    self._completed[rid] = seq.tokens
                    self._score_completion(rid, now)
        if rank == 0 and not front.get("shutdown"):
            idle = (not self._pending
                    and self._arrival_idx < len(self.trace)
                    and (size > 1 or not self.engine.scheduler.running))
            if idle:
                time.sleep(0.002)     # an idle beat: the trace clock runs
        return bool(front.get("shutdown"))

    # ---- decode-rank report bookkeeping -------------------------------

    def _done_out(self):
        """Move fresh completions into the outbox and return all of it:
        items re-send every round until retired (draining at send would
        lose a completion to a fault mid-round)."""
        for rid, seq in list(self.engine.scheduler.completed.items()):
            self._done_outbox[int(rid)] = seq.tokens.tolist()
            del self.engine.scheduler.completed[rid]
            self.served_local += 1
        return dict(self._done_outbox)

    def _retire_inflight(self, sent_ctl):
        """A successful allgather proves the frontend applied the
        previous round's reports: retire what was in flight, and this
        round's become in flight."""
        for rid in self._inflight["acks"]:
            if rid in self._ack_buf:
                self._ack_buf.remove(rid)
        for rid in self._inflight["rejects"]:
            if rid in self._reject_buf:
                self._reject_buf.remove(rid)
        for rid in self._inflight["done"]:
            self._done_outbox.pop(rid, None)
        self._inflight = {"acks": list(sent_ctl["acks"]),
                          "rejects": list(sent_ctl["rejects"]),
                          "done": list(sent_ctl["done"])}

    def _apply_decode_report(self, peer_rank, peer, now):
        for rid in peer.get("acks", ()):
            rec = self._assigned.get(rid)
            if rec is not None and rec["rank"] == peer_rank:
                rec["acked"] = True
        for rid in peer.get("rejects", ()):
            rec = self._assigned.pop(rid, None)
            if rec is not None:
                # NACK (decode pool full): back to the head of the line.
                reqtrace.record_request("queued", rid,
                                        aux=len(rec["req"].prompt))
                self._pending.insert(0, rec["req"])
        for rid, tokens in peer.get("done", {}).items():
            rid = int(rid)
            if rid in self._completed:
                continue  # a duplicate: the first completion won
            self._completed[rid] = np.asarray(tokens, np.int32)
            self._score_completion(rid, now, remote=True)
            # A re-queued copy may be pending here or on another rank.
            rec = self._assigned.pop(rid, None)
            if rec is not None and rec["rank"] != peer_rank:
                self._cancel.append(rid)
            self._pending = [r for r in self._pending if r.rid != rid]

    def _exchange_payloads(self, rank, size, front, packed, tag):
        """One host uint8 alltoall over the lane's gloo side: the
        frontend's packed payloads to their ranks."""
        from horovod_tpu_torch.torch import mpi_ops

        splits = [0] * size
        chunks = []
        if rank == 0:
            for target in range(size):
                for _, payload in packed.get(target, ()):
                    splits[target] += len(payload)
                    chunks.append(payload)
        buf = torch.frombuffer(bytearray(b"".join(chunks)), dtype=torch.uint8) \
            if chunks else torch.zeros(0, dtype=torch.uint8)
        out = mpi_ops.alltoall(buf, splits, name=f"{tag}.kv")
        if rank == 0:
            return
        # Everything received came from rank 0, packed in assignment
        # order for this rank.
        data = out.numpy().tobytes()
        off = 0
        for meta in (m for m in front["assign"] if m["target"] == rank):
            payload = data[off:off + meta["nbytes"]]
            off += meta["nbytes"]
            if self._adopt_assignment(meta, payload):
                self._ack_buf.append(meta["rid"])
            else:
                self._reject_buf.append(meta["rid"])
