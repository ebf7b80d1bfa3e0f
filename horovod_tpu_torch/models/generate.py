"""KV-cached autoregressive decoding for the Llama family, dense and MoE.

Counterpart of horovod_tpu/models/generate.py. Prefill runs every layer
over the whole prompt with attention on the K1 kernel
(``ops.flash_attention``); offline decoding (:func:`llama_generate`)
runs one token at a time with attention on the K4 kernel
(``ops.decode_attention``); the continuous-batching step
(:func:`llama_decode_step`) attends with the plain
``decode_attention_ragged``, as the JAX package does on every platform.

The JAX module's ``lax.scan``s over layers and tokens are Python loops
here, and PyTorch runs them eagerly. An MoE layer's FFN takes the
grouped dispatch (``ops/grouped_moe.py``, K5) at prefill; a decode step
takes the top-K weight gather (:func:`_moe_ffn_topk`, plain einsums)
while B*T*K < E, and the grouped dispatch beyond (:func:`_decode_ffn`).
"""

import torch
import torch.nn.functional as F

from horovod_tpu_torch._device import on_device as _on_device
from horovod_tpu_torch.models.llama import _ffn as _llama_ffn
from horovod_tpu_torch.models.llama import _rmsnorm, _rope, moe_route
from horovod_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_ragged,
)
from horovod_tpu_torch.ops.flash_attention import flash_attention


def _ffn(h, lp, c):
    """llama.py's FFN with the aux loss dropped (decode does not train).
    Serves prefill, dense decode, and MoE decode at larger batch."""
    y, _aux = _llama_ffn(h, lp, c)
    return y


def _moe_ffn_topk(h, lp, c):
    """Decode-step MoE FFN: gather only the K routed experts' weights
    per token and contract with them, so FLOPs and weight reads scale
    with K, not E (the same router and gate normalisation as the
    grouped dispatch). Each token holds its own [K, D, F] weight copy,
    so this path only wins while B*T*K < E (:func:`_decode_ffn`). The
    weights are gathered, then cast: the same values as JAX's
    cast-then-gather."""
    dt = c.compute_dtype
    gate_vals, gate_idx, _aux = moe_route(h, lp["router"],
                                          c.n_experts_per_token)
    idx = gate_idx.long()                                    # [B, T, K]
    wg = lp["moe_gate"][idx].to(dt)                          # [B,T,K,D,F]
    wu = lp["moe_up"][idx].to(dt)
    wd = lp["moe_down"][idx].to(dt)                          # [B,T,K,F,D]
    hk = h.to(dt)
    gate = F.silu(torch.einsum("btd,btkdf->btkf", hk, wg))
    up = torch.einsum("btd,btkdf->btkf", hk, wu)
    y = torch.einsum("btkf,btkfd->btkd", gate * up, wd)
    return torch.einsum("btk,btkd->btd", gate_vals.to(dt), y)


def _decode_ffn(h, lp, c):
    """FFN of a decode step: dense as is; MoE by the top-K gather while
    it touches fewer weights than the grouped dispatch over all E
    experts (B*T*K < E), else the grouped dispatch (K5)."""
    if c.n_experts > 0:
        b, t, _ = h.shape
        if b * t * c.n_experts_per_token < c.n_experts:
            return _moe_ffn_topk(h, lp, c)
    return _ffn(h, lp, c)


def _layer(params, li):
    """Layer ``li``'s slice of the stacked [L, ...] parameters (views)."""
    return {k: w[li] for k, w in params["layers"].items()}


def _layer_kv(h, lp, c, positions):
    """Project h [B, T, D] (normalised) -> rope'd k and v
    [B, T, Hkv, hd] for one layer."""
    dt = c.compute_dtype
    b, t = h.shape[0], h.shape[1]
    k = (h @ lp["wk"].to(dt)).reshape(b, t, c.n_kv_heads, c.head_dim)
    v = (h @ lp["wv"].to(dt)).reshape(b, t, c.n_kv_heads, c.head_dim)
    return _rope(k, positions, c.rope_theta), v


def _attend_step(x, lp, c, cache_k, cache_v, li, pos):
    """One decode-position layer step against the stacked caches.

    x [B, D]; cache_k/v [L, B, Hkv, max_len, hd] with slots < pos
    valid. This step's k/v are written at (li, :, :, pos) IN PLACE (the
    JAX version is functional and returns updated carries; an in-place
    write saves a copy of the whole cache per token), then attended on
    K4 with slots <= pos valid. Returns (x_out, cache_k, cache_v).
    """
    dt = c.compute_dtype
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    h = _rmsnorm(x, lp["attn_norm"].to(dt), c.norm_eps)
    q = (h @ lp["wq"].to(dt)).reshape(b, 1, c.n_heads, c.head_dim)
    q = _rope(q, positions, c.rope_theta)
    k_new, v_new = _layer_kv(h[:, None, :], lp, c, positions)
    cache_k[li, :, :, pos] = k_new[:, 0]
    cache_v[li, :, :, pos] = v_new[:, 0]
    attn = decode_attention(q, cache_k[li], cache_v[li], pos)
    x = x + attn.reshape(b, -1) @ lp["wo"].to(dt)
    h = _rmsnorm(x, lp["mlp_norm"].to(dt), c.norm_eps)
    x = x + _decode_ffn(h[:, None, :], lp, c)[:, 0, :]
    return x, cache_k, cache_v


def _prefill(params, prompt, c, pad_to):
    """One full-sequence pass capturing each layer's K/V.

    Returns (x [B, T, D] final hidden states, cache_k, cache_v
    [L, B, Hkv, T + pad_to, hd] heads-major, zero past T)."""
    dt = c.compute_dtype
    b, t0 = prompt.shape
    x = params["embed"].to(dt)[prompt.long()]
    positions = torch.arange(t0, device=x.device).expand(b, t0)
    shape = (c.n_layers, b, c.n_kv_heads, t0 + pad_to, c.head_dim)
    cache_k = torch.zeros(shape, dtype=dt, device=x.device)
    cache_v = torch.zeros(shape, dtype=dt, device=x.device)
    for li in range(c.n_layers):
        lp = _layer(params, li)
        h = _rmsnorm(x, lp["attn_norm"].to(dt), c.norm_eps)
        q = (h @ lp["wq"].to(dt)).reshape(b, t0, c.n_heads, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k, v = _layer_kv(h, lp, c, positions)
        attn = flash_attention(q, k, v, causal=True)
        x = x + attn.reshape(b, t0, -1) @ lp["wo"].to(dt)
        h = _rmsnorm(x, lp["mlp_norm"].to(dt), c.norm_eps)
        x = x + _ffn(h, lp, c)
        cache_k[li, :, :, :t0] = k.transpose(1, 2)
        cache_v[li, :, :, :t0] = v.transpose(1, 2)
    return x, cache_k, cache_v


def _lm_logits(params, x_last, c):
    """Final norm + lm_head, logits in f32 (x_last [..., D])."""
    dt = c.compute_dtype
    h = _rmsnorm(x_last, params["final_norm"].to(dt), c.norm_eps)
    return (h @ params["lm_head"].to(dt)).float()


@torch.no_grad()
def llama_prefill(params, prompt, config, pad_to=0, device=None):
    """Serving-lane prefill: the greedy first token plus the prompt's
    per-layer K/V.

    prompt [B, T] int -> (first [B] in prompt's dtype, cache_k, cache_v
    [L, B, Hkv, T + pad_to, hd]), unpadded by default: the engine writes
    them into paged blocks."""
    _, a = _on_device(params, device, prompt=prompt)
    prompt = a["prompt"]
    x, cache_k, cache_v = _prefill(params, prompt, config, pad_to)
    logits = _lm_logits(params, x[:, -1, :], config)
    return logits.argmax(-1).to(prompt.dtype), cache_k, cache_v


@torch.no_grad()
def llama_decode_step(params, tokens, cache_k, cache_v, lengths, config,
                      k_scale=None, v_scale=None, device=None):
    """One continuous-batching decode step over a ragged batch.

    Row b holds its own sequence with ``lengths[b]`` valid cached slots
    (the gathered caches are padded to one S; the mask carries the
    raggedness). tokens [B] int (each row's last emitted token);
    cache_k/v [L, B, Hkv, S, hd] f32/bf16, or int8 with per-slot scales
    ``k_scale``/``v_scale`` [L, B, Hkv, S].

    Returns (next [B] greedy tokens, k_new, v_new [L, B, Hkv, hd]):
    this step's projections, which the caller writes into its paged
    cache; the step does not touch the caches.
    """
    _, a = _on_device(params, device, tokens=tokens, cache_k=cache_k,
                      cache_v=cache_v, lengths=lengths, k_scale=k_scale,
                      v_scale=v_scale)
    c = config
    dt = c.compute_dtype
    tokens, lengths = a["tokens"], a["lengths"]
    b = tokens.shape[0]
    x = params["embed"].to(dt)[tokens.long()]                # [B, D]
    positions = lengths.to(torch.int64)[:, None]             # [B, 1]
    k_out, v_out = [], []
    for li in range(c.n_layers):
        lp = _layer(params, li)
        h = _rmsnorm(x, lp["attn_norm"].to(dt), c.norm_eps)
        q = (h @ lp["wq"].to(dt)).reshape(b, 1, c.n_heads, c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        k_new, v_new = _layer_kv(h[:, None, :], lp, c, positions)
        attn = decode_attention_ragged(
            q, a["cache_k"][li], a["cache_v"][li], lengths,
            k_new.transpose(1, 2), v_new.transpose(1, 2),
            k_scale=None if a["k_scale"] is None else a["k_scale"][li],
            v_scale=None if a["v_scale"] is None else a["v_scale"][li])
        x = x + attn.reshape(b, -1) @ lp["wo"].to(dt)
        h = _rmsnorm(x, lp["mlp_norm"].to(dt), c.norm_eps)
        x = x + _decode_ffn(h[:, None, :], lp, c)[:, 0, :]
        k_out.append(k_new[:, 0])
        v_out.append(v_new[:, 0])
    nxt = _lm_logits(params, x, c).argmax(-1).to(tokens.dtype)
    return nxt, torch.stack(k_out), torch.stack(v_out)


@torch.no_grad()
def llama_generate(params, prompt, config, max_new_tokens,
                   temperature=0.0, generator=None, device=None):
    """Greedy (temperature=0) or sampled decoding.

    prompt [B, T] int -> [B, T + max_new_tokens] (prompt + generated).
    Sampling draws from ``generator`` (a ``torch.Generator`` on the
    run's device; default: one seeded with 0, as the JAX version
    defaults to PRNGKey(0)).
    """
    dev, a = _on_device(params, device, prompt=prompt)
    prompt = a["prompt"]
    c = config
    dt = c.compute_dtype
    t0 = prompt.shape[1]
    if temperature != 0.0 and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def pick(logits):
        if temperature == 0.0:
            return logits.argmax(-1).to(prompt.dtype)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompt.dtype)

    x, cache_k, cache_v = _prefill(params, prompt, c, max_new_tokens)
    token = pick(_lm_logits(params, x[:, -1, :], c))
    out = [token]
    for pos in range(t0, t0 + max_new_tokens - 1):
        x = params["embed"].to(dt)[token.long()]               # [B, D]
        for li in range(c.n_layers):
            x, cache_k, cache_v = _attend_step(
                x, _layer(params, li), c, cache_k, cache_v, li, pos)
        token = pick(_lm_logits(params, x, c))
        out.append(token)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1)
