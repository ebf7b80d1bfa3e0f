"""Ring attention: exact attention over a sequence sharded on the mesh's
``seq`` axis.

Counterpart of horovod_tpu/parallel/ring_attention.py. Each rank holds
its contiguous shard of q, k and v; at every step it attends its queries
to the K/V shard it holds, then passes K/V one hop around the ring
(:func:`parallel.ops.ppermute_ring`). After ``n`` steps every query has
seen every key once, and the online-softmax merge makes the result
exact. Causal masking compares global positions.

Two paths, as in JAX: the flash path (:func:`ring_flash_steps`) runs one
``flash_attention_chunk`` per step (K1's offsets variant forward, K2 and
K3's backward, with the lse cotangent) and merges the steps' (o, lse) by
logaddexp in f32, rotating K/V unrepeated at their Hkv heads; the
blockwise path is plain PyTorch (repeated K/V, running max and sum). The
flash path is the default for CUDA tensors, the blockwise path for CPU
tensors, as JAX picks by platform.

Unlike JAX's, whose ``ring_self_attention`` takes global arrays and runs
under ``shard_map``, these functions take this rank's local shards
(``Mesh.shard``) and return its shard of the output.
"""

import torch

from horovod_tpu_torch.ops.flash_attention import flash_attention_chunk
from horovod_tpu_torch.parallel.ops import ppermute_ring

_NEG_BIG = -1e30  # finite stand-in for -inf: keeps exp() NaN-free


def _repeat_kv(x, n_rep):
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] for grouped-query
    attention (query head h reads kv head h // n_rep)."""
    return x if n_rep == 1 else x.repeat_interleave(n_rep, dim=2)


def _attn_block(q, k, v, q_pos, kv_pos, causal, scale):
    """One block's unnormalised (o, m, l): q [B, Tq, H, D], k/v
    [B, Tk, H, D], global positions; o f32 [B, Tq, H, D], m and l f32
    [B, H, Tq]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        visible = kv_pos[None, :] <= q_pos[:, None]
        s = torch.where(visible, s, torch.full_like(s, _NEG_BIG))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    if causal:
        p = torch.where(visible, p, torch.zeros_like(p))
    l = p.sum(-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return o, m, l


def _combine(o, m, l, o_blk, m_blk, l_blk):
    """Merge a block into the running online-softmax accumulators."""
    m_new = torch.maximum(m, m_blk)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(m_blk - m_new)

    def bcast(x):  # [B, H, Tq] -> [B, Tq, H, 1]
        return x.transpose(1, 2)[..., None]

    return (bcast(alpha) * o + bcast(beta) * o_blk, m_new,
            alpha * l + beta * l_blk)


def _normalise(o, l, dtype):
    return (o / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
            ).to(dtype)


def blockwise_attention(q, k, v, causal=True, q_offset=0, kv_offset=0):
    """Plain one-rank attention with a global-position causal mask: q
    [B, Tq, H, D], k/v [B, Tk, Hkv, D]; the offsets are the global index
    of the first query and key."""
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
    kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
    o, _, l = _attn_block(q, k, v, q_pos, kv_pos, causal,
                          q.shape[-1] ** -0.5)
    return _normalise(o, l, q.dtype)


def ring_flash_steps(qt, kt, vt, idx, n, rotate, causal=True):
    """Rank ``idx``'s ``n`` ring steps on the flash op, in the kernel
    layout (qt [B, H, Tq, D], kt/vt [B, Hkv, Tk, D]): at step s it holds
    the K/V shard of rank (idx - s) mod n and attends its queries (global
    start idx·Tq) to it (global start src·Tk); ``rotate(kt, vt)`` returns
    the next step's shard (on a mesh, the ring shift). Returns the f32
    merge (o [B, H, Tq, D], lse [B, H, Tq, 1])."""
    b, h, tq, d = qt.shape
    tk = kt.shape[2]
    o = torch.zeros((b, h, tq, d), dtype=torch.float32, device=qt.device)
    lse = torch.full((b, h, tq, 1), float("-inf"), dtype=torch.float32,
                     device=qt.device)
    for step in range(n):
        src = (idx - step) % n
        o_blk, lse_blk = flash_attention_chunk(qt, kt, vt, idx * tq,
                                               src * tk, causal)
        new_lse = torch.logaddexp(lse, lse_blk)
        o = (torch.exp(lse - new_lse) * o
             + torch.exp(lse_blk - new_lse) * o_blk.float())
        lse = new_lse
        if step != n - 1:
            kt, vt = rotate(kt, vt)
    return o, lse


def _ring_blockwise(q, k, v, idx, n, rotate, causal):
    n_rep = q.shape[2] // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    b, tq, h, d = q.shape
    tk = k.shape[1]
    q_pos = idx * tq + torch.arange(tq, device=q.device)
    o = torch.zeros((b, tq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    for step in range(n):
        src = (idx - step) % n
        kv_pos = src * tk + torch.arange(tk, device=q.device)
        o, m, l = _combine(o, m, l, *_attn_block(q, k, v, q_pos, kv_pos,
                                                 causal, scale))
        if step != n - 1:
            k, v = rotate(k, v)
    return _normalise(o, l, q.dtype)


def ring_attention(q, k, v, mesh, axis="seq", causal=True, use_flash=None):
    """Exact attention with the sequence sharded over ``mesh``'s
    ``axis``: this rank's shards q [B, Tq, H, D], k/v [B, Tk, Hkv, D] ->
    its shard of the output [B, Tq, H, D] in q's dtype. ``use_flash``
    (default: True for CUDA tensors, False for CPU tensors) picks the
    flash path over the blockwise one."""
    n, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    group = mesh.axis_group(axis)

    def rotate(kk, vv):
        return ppermute_ring((kk, vv), group)

    if use_flash is None:
        use_flash = q.is_cuda
    if not use_flash:
        return _ring_blockwise(q, k, v, idx, n, rotate, causal)
    o, _ = ring_flash_steps(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), idx, n, rotate, causal)
    return o.transpose(1, 2).to(q.dtype)


def ring_self_attention(q, k, v, mesh, causal=True, seq_axis="seq"):
    """The model-facing entry (JAX's name): :func:`ring_attention` of
    this rank's (data, seq) shards over ``seq_axis``."""
    return ring_attention(q, k, v, mesh, seq_axis, causal)
