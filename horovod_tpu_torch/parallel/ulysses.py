"""Ulysses sequence parallelism: an all-to-all from sequence shards to
head shards, full-sequence attention per head group, and back.

Counterpart of horovod_tpu/parallel/ulysses.py. Two all-to-alls
(:func:`parallel.ops.all_to_all`) re-shard this rank's q/k/v from (T/P
tokens, all heads) to (all T tokens, H/P heads), the local attention
runs unchanged (the flash op, K1-K3, for CUDA tensors; the blockwise
plain path for CPU tensors, as JAX picks by platform), and one more
all-to-all shards the output back. The axis size P must divide the head
count; when it does not divide Hkv, K/V heads are replicated up to
lcm(Hkv, P) first. Inputs and output are this rank's local shards.
"""

import math

from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.ops import all_to_all
from horovod_tpu_torch.parallel.ring_attention import (
    _repeat_kv,
    blockwise_attention,
)


def ulysses_attention(q, k, v, mesh, axis="seq", causal=True,
                      use_flash=None):
    """Exact attention with the sequence sharded over ``mesh``'s
    ``axis``: this rank's shards q [B, T/P, H, D], k/v [B, T/P, Hkv, D]
    -> its shard of the output [B, T/P, H, D]. Needs H % P == 0."""
    n = mesh.axis_size(axis)
    group = mesh.axis_group(axis)
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses_attention needs n_heads ({h}) divisible by the "
            f"'{axis}' axis size ({n}); use ring_attention otherwise")
    if k.shape[2] % n:
        # Replicate K/V only up to lcm(Hkv, P): both divide H, so the lcm
        # does too, and the local attention re-expands the rest.
        target = k.shape[2] * n // math.gcd(k.shape[2], n)
        k = _repeat_kv(k, target // k.shape[2])
        v = _repeat_kv(v, target // v.shape[2])

    def to_heads(x):  # [B, T/P, H', D] -> [B, T, H'/P, D]
        return all_to_all(x, group, split_axis=2, concat_axis=1)

    qg, kg, vg = to_heads(q), to_heads(k), to_heads(v)
    if use_flash is None:
        use_flash = q.is_cuda
    attend = flash_attention if use_flash else blockwise_attention
    out = attend(qg, kg, vg, causal=causal)
    # [B, T, H/P, D] -> [B, T/P, H, D]
    return all_to_all(out, group, split_axis=1, concat_axis=2)


def ulysses_self_attention(q, k, v, mesh, causal=True, seq_axis="seq"):
    """The model-facing entry (JAX's name): :func:`ulysses_attention` of
    this rank's (data, seq) shards over ``seq_axis``."""
    return ulysses_attention(q, k, v, mesh, seq_axis, causal)
