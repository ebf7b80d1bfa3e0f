"""Continuous-batching decode engine over the paged KV cache.

Counterpart of horovod_tpu/serving/engine.py:DecodeEngine. One
``step()`` admits through the scheduler, prefills admitted prompts
(``llama_prefill``: attention on the K1 kernel) into pool blocks, and
decodes every running sequence with ``llama_decode_step`` at STATIC
shapes: the batch padded to ``max_batch`` rows and each gathered cache
to ``max_context`` rounded up to whole blocks, raggedness carried by
the ``lengths`` mask. The static shapes keep the numerics independent
of which requests share a step, the property token-identical
eviction replay rests on. Padding rows decode a dummy token at length
0 and are discarded.

The pool lives on the host; each step's gathered view moves to the
engine's device once. Each transition of a request is recorded for
request tracing (``telemetry/reqtrace.py``), as the reference's engine
records it; :meth:`DecodeEngine.adopt_remote` takes a sequence whose
blocks another rank prefilled (``serving/service.py``).
"""

import torch

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.models.generate import (
    llama_decode_step,
    llama_prefill,
)
from horovod_tpu_torch.serving.kvcache import PagedKVCache
from horovod_tpu_torch.serving.scheduler import ContinuousBatchingScheduler
from horovod_tpu_torch.telemetry import reqtrace


class DecodeEngine:
    """Single-rank continuous-batching decode over a paged pool."""

    def __init__(self, params, config, *, block_size=16, n_blocks=256,
                 max_batch=8, max_context=512, token_budget=None,
                 quantized=False, device=None):
        self.params = params
        self.config = config
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.pool = PagedKVCache(
            config.n_layers, config.n_kv_heads, config.head_dim,
            block_size=block_size, n_blocks=n_blocks,
            dtype=config.compute_dtype, quantized=quantized)
        # Static gathered-cache length: whole blocks covering max_context.
        self.blocks_per_seq = self.pool.blocks_for(int(max_context))
        self.s_pad = self.blocks_per_seq * self.pool.block_size
        self.scheduler = ContinuousBatchingScheduler(
            self.pool, max_batch=max_batch,
            token_budget=int(token_budget) if token_budget
            else self.s_pad * max_batch)
        self.steps = 0

    # ---- admission ----------------------------------------------------

    def submit(self, req):
        """Queue a request for local prefill + decode."""
        if len(req.prompt) + req.max_new_tokens > self.s_pad:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + "
                f"max_new {req.max_new_tokens} exceeds max_context "
                f"{self.s_pad}")
        self.scheduler.submit(req)

    def prefill(self, req):
        """Prefill one request; returns (first_token, k, v
        [L, Hkv, T, D] on the host)."""
        prompt = torch.as_tensor(req.prompt, dtype=torch.int32)[None, :]
        first, ck, cv = llama_prefill(self.params, prompt, self.config,
                                      device=self.device)
        # [L, 1, Hkv, T, D] -> [L, Hkv, T, D]
        return int(first[0]), ck[:, 0].cpu(), cv[:, 0].cpu()

    def _admit_local(self):
        for seq in self.scheduler.admit():
            reqtrace.record_request("prefill", seq.rid,
                                    aux=len(seq.req.prompt))
            first, k, v = self.prefill(seq.req)
            self.pool.write(seq.blocks, 0, k, v)
            seq.generated.append(first)
            if seq.done:  # max_new_tokens == 1: prefill finished it
                self.scheduler.complete(seq)
            else:
                reqtrace.record_request("decode_wait", seq.rid)

    def adopt_remote(self, seq):
        """Register a sequence whose blocks were shipped in (the
        service's decode ranks); the caller allocated and wrote them."""
        reqtrace.record_request("decode_wait", seq.rid,
                                aux=len(seq.blocks))
        self.scheduler.adopt(seq)

    # ---- the decode step ----------------------------------------------

    def step(self):
        """One continuous-batching step: admit, then one token for
        every running sequence. Returns [(rid, token, done), ...]."""
        self._admit_local()
        # ensure_slot may evict other running sequences, so iterate a
        # snapshot and re-check membership afterwards.
        snapshot = list(self.scheduler.running)
        for seq in snapshot:
            if seq in self.scheduler.running:
                self.scheduler.ensure_slot(seq)
        live = [s for s in snapshot if s in self.scheduler.running]
        if not live:
            return []
        live = live[:self.max_batch]
        for seq in live:
            reqtrace.record_request("decode_active", seq.rid,
                                    aux=seq.cached)
        out = self._decode_batch(live)
        events = []
        for seq, tok in zip(live, out):
            seq.generated.append(tok)
            events.append((seq.rid, tok, seq.done))
            if seq.done:
                self.scheduler.complete(seq)
            else:
                reqtrace.record_request("decode_wait", seq.rid)
        self.steps += 1
        return events

    def _decode_batch(self, live):
        c = self.config
        b_pad = self.max_batch
        dt = c.compute_dtype
        quant = self.pool.quantized
        store = torch.int8 if quant else dt
        tokens = torch.zeros(b_pad, dtype=torch.int32)
        lengths = torch.zeros(b_pad, dtype=torch.int32)
        shape = (c.n_layers, b_pad, c.n_kv_heads, self.s_pad, c.head_dim)
        ck = torch.zeros(shape, dtype=store)
        cv = torch.zeros(shape, dtype=store)
        ks = vs = None
        if quant:
            ks = torch.zeros(shape[:-1], dtype=torch.float32)
            vs = torch.zeros(shape[:-1], dtype=torch.float32)
        for i, seq in enumerate(live):
            tokens[i] = seq.generated[-1]
            lengths[i] = seq.cached
            k, v, k_s, v_s = self.pool.gather(
                seq.blocks, pad_blocks=self.blocks_per_seq
                - len(seq.blocks))
            ck[:, i], cv[:, i] = k, v
            if quant:
                ks[:, i], vs[:, i] = k_s, v_s
        nxt, k_new, v_new = llama_decode_step(
            self.params, tokens, ck, cv, lengths, c, k_scale=ks,
            v_scale=vs, device=self.device)
        new_dt = torch.float32 if quant else dt
        nxt = nxt.cpu()
        k_new = k_new.to("cpu", new_dt)
        v_new = v_new.to("cpu", new_dt)
        for i, seq in enumerate(live):
            # [L, Hkv, D] -> [L, Hkv, 1, D] at the slot ensure_slot
            # just guaranteed.
            self.pool.write(seq.blocks, seq.cached,
                            k_new[:, i][:, :, None, :],
                            v_new[:, i][:, :, None, :])
        return [int(t) for t in nxt[:len(live)]]

    # ---- drive to completion -------------------------------------------

    def run_until_idle(self, max_steps=100000):
        """Decode until nothing is waiting or running. Returns the
        completed {rid: tokens} map."""
        steps = 0
        while self.scheduler.waiting or self.scheduler.running:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError("run_until_idle: no convergence "
                                   f"after {max_steps} steps")
        return {rid: s.tokens for rid, s in
                self.scheduler.completed.items()}
