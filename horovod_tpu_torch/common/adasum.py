"""Adasum: the scale-invariant pairwise combine and its exchange schedule.

Counterpart of ``csrc/adasum.cc`` (``AdasumCombine:25``,
``AdasumAllreduce:79``), which the reference's host lane runs, and of
``horovod_tpu/jax/xla_ici.py:470 _adasum_combine``. Given partner
gradients a and b::

    adasum(a, b) = (1 - a.b / (2|a|^2)) a + (1 - a.b / (2|b|^2)) b

with the dot products in f64 (as the host lane: f16/bf16 are widened to
f32 first) and a zero-norm side added as it is. The ranks of a set
below the largest power of two p exchange by recursive doubling; the
``extras`` at positions >= p first fold into their partner at
``pos - p`` and get the result back at the end. Both partners of a stage
compute the same symmetric combine, so they hold the same bits.
"""

import torch

FLOATING = (torch.float16, torch.bfloat16, torch.float32, torch.float64)


def combine_(a, b):
    """``a <- adasum(a, b)`` for 1-D tensors of one floating dtype."""
    a64, b64 = a.double(), b.double()
    dot = torch.dot(a64, b64)
    na = torch.dot(a64, a64)
    nb = torch.dot(b64, b64)
    one = torch.ones((), dtype=torch.float64, device=a.device)
    ca = torch.where(na == 0, one, 1.0 - dot / (2.0 * na))
    cb = torch.where(nb == 0, one, 1.0 - dot / (2.0 * nb))
    out = ca * a64 + cb * b64
    if a.dtype in (torch.float16, torch.bfloat16):
        out = out.float()
    a.copy_(out)
    return a


def allreduce_(buf, pos, n, send, recv, exchange):
    """Adasum over a set of ``n`` members, in place on ``buf`` (1-D) at
    position ``pos``. ``send(t, peer_pos)``, ``recv(t, peer_pos)`` and
    ``exchange(t_out, t_in, peer_pos)`` move tensors between set
    positions."""
    p = 1
    while p * 2 <= n:
        p *= 2
    extras = n - p
    if pos >= p:
        send(buf, pos - p)
        recv(buf, pos - p)
        return buf
    remote = torch.empty_like(buf)
    if pos < extras:
        recv(remote, pos + p)
        combine_(buf, remote)
    dist_ = 1
    while dist_ < p:
        exchange(buf, remote, pos ^ dist_)
        combine_(buf, remote)
        dist_ *= 2
    if pos < extras:
        send(buf, pos + p)
    return buf
