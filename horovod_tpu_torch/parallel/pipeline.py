"""Pipeline parallelism over the mesh's ``pipe`` axis: the gpipe, 1F1B
and interleaved 1F1B schedules.

Counterpart of horovod_tpu/parallel/pipeline.py. The layer stack is cut
into ``S`` stages (each ``V`` chunks under the interleaved schedule, the
chunk ``v`` of stage ``s`` being global stage ``v * S + s``), the batch
into ``M`` microbatches, and the schedule says, slot by slot, which
stage runs which (chunk, microbatch) forward or backward; activations
travel one stage down the ring and cotangents one stage up between
slots. The host-side schedule logic is the JAX package's, copied:
:func:`build_interleaved_schedule` (its tables bit-equal to JAX's, with
the same build-time dependency and stash-collision asserts),
:func:`_chunk_permutation`, and the slot arithmetic of gpipe (stage
``s`` forwards microbatch ``m`` at slot ``s + m``) and of lockstep 1F1B
(the forward at slot ``s + m``, the backward at ``2(S-1) - s + m``, at
most ``min(M, 2S - 1)`` stashed inputs a stage).

JAX runs a schedule as one ``lax.scan`` inside a ``shard_map`` manual
over ``pipe``. The port runs it eagerly, one slot at a time, behind a
transport that moves what crosses a stage boundary:

- :class:`MeshTransport`: one stage a rank, the mesh's ``pipe`` group,
  each slot's sends and receives paired by one
  ``dist.batch_isend_irecv`` (NCCL on the card, gloo for
  ``device="cpu"``). The ranks of a stage post the same P2P and the
  same ``tensor``/``fsdp`` collectives in the same order, since every
  rank walks the same tables. A mesh uses only this transport.
- :class:`InProcessTransport`: all ``S`` stages in this process, as
  JAX's ``_pipe_spmd`` emulates the axis under ``vmap``; taken only by
  explicit call (the CPU tests, the one-card replay).

A deliberate difference, same numbers: JAX's scan computes on garbage in
a bubble slot and masks the result; the port runs no stage work and
sends nothing there. So a schedule launches each kernel once per (layer,
microbatch) forward and once per backward recompute, never in a bubble.

The static-analysis hooks are JAX's too: :func:`build_pipeline_inner`
binds a schedule to a transport as the program hvdlint runs, and
:func:`predicted_collectives` predicts what one stage of it issues, from
the same slot plans the engine walks (bubble slots, where the port
exchanges nothing, issue nothing).

The public functions keep JAX's contracts: :func:`gpipe` returns ``(ys,
aux_sum)`` (differentiable: under autograd its training path is an
explicit fill and drain inside one ``torch.autograd.Function``, all
forwards with their graphs kept, then the backwards in reverse with the
cotangents sent up explicitly); :func:`one_f_one_b` and
:func:`interleaved_one_f_one_b` return ``(loss_sum, aux_sum,
d_stage_params, d_head_params, d_xs)``, each stage stashing its inputs
and re-running its forward under autograd in the backward subtick
(JAX's per-stage remat). The head-param and ``d_xs`` cotangents live on
one stage each and are shared over ``pipe`` by a broadcast from it,
which gives the bits of JAX's f32 ``psum`` of one nonzero term; the loss
sits on the last stage and is broadcast, the aux sum is summed.

``stage_params`` is a tree of stacked ``[n, ...]`` leaves: under
:class:`InProcessTransport` the whole stack in canonical layer order
(``n = S * V * Lb``; chunk ``(s, v)`` is rows of global stage ``v * S +
s``), under :class:`MeshTransport` this rank's block of ``V`` chunks
(``n = V * Lb``) in the device-major order of :func:`_chunk_permutation`
(``shard_params`` with ``llama_partition_rules(pipeline=True,
virtual=V)`` hands it so). Gradients come back in the same layout.
"""

from datetime import timedelta
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten

SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b")
_F, _B = 0, 1
_TIMEOUT = timedelta(seconds=120)


# ---- host-side schedules (the JAX package's) --------------------------------

class InterleavedSchedule(NamedTuple):
    """Host-built slot tables for the interleaved 1F1B engine (JAX's):
    every slot is ONE subtick a device, forward, backward or idle. All
    tables are ``[n_slots, S]`` int32, indexed by the acting device."""
    S: int
    V: int
    M: int
    n_slots: int
    stash_depth: int          # activation-ring slots per chunk (Q)
    ctg_depth: int            # cotangent-ring slots per chunk (Qb)
    kind: np.ndarray          # 0=forward, 1=backward, 2=idle,
    #                           3=forward+loss-head (final global stage)
    chunk: np.ndarray         # acting chunk v (0 when idle)
    mb: np.ndarray            # acting microbatch m (0 when idle)
    stash_idx: np.ndarray     # v*Q  + m%Q   of the acting task
    ctg_idx: np.ndarray       # v*Qb + m%Qb  of the acting task
    rf_valid: np.ndarray      # activation arriving on the fwd carry?
    rf_idx: np.ndarray        # its stash slot (v*Q + m%Q)
    rb_valid: np.ndarray      # cotangent arriving on the bwd carry?
    rb_idx: np.ndarray        # its ctg slot (v*Qb + m%Qb)

    @property
    def bubble_fraction(self):
        """Idle subticks / total subticks over the whole schedule."""
        return 1.0 - 2.0 * self.M * self.V / self.n_slots


def build_interleaved_schedule(S, V, M):
    """Slot tables for ``S`` devices x ``V`` chunks x ``M`` microbatches
    (JAX's ``build_interleaved_schedule``, table for table): forwards in
    Megatron's chunk-major group order, backwards mirroring them, each
    device holding its in-flight forwards at the warm-up quota
    ``2*(S-1-s) + (V-1)*S`` once past it; one list-scheduling pass with
    one ring hop a slot boundary. ``2*M*V + 2*(S-1)`` slots whenever
    ``S | M``; dependency-safety and stash-ring collision-freedom are
    asserted here."""
    if S < 1 or V < 1 or M < 1:
        raise ValueError(f"need S,V,M >= 1, got S={S} V={V} M={M}")
    total = M * V

    def warm(s):
        return min(2 * (S - 1 - s) + (V - 1) * S, total)

    fwd_q = {s: sorted(((v, m) for v in range(V) for m in range(M)),
                       key=lambda t: (t[1] // S, t[0], t[1] % S))
             for s in range(S)}
    bwd_q = {s: sorted(((v, m) for v in range(V) for m in range(M)),
                       key=lambda t: (t[1] // S, V - 1 - t[0], t[1] % S))
             for s in range(S)}
    f_slot, b_slot = {}, {}

    def f_arrival(s, v, m):
        if s == 0 and v == 0:
            return 0                      # injected from xs
        prod = f_slot.get((s - 1, v, m)) if s > 0 \
            else f_slot.get((S - 1, v - 1, m))
        return None if prod is None else prod + 1

    def b_arrival(s, v, m):
        own = f_slot.get((s, v, m))
        if own is None:
            return None                   # own forward not yet run
        if s == S - 1 and v == V - 1:
            return own + 1                # loss cotangent, made locally
        prod = b_slot.get((0, v + 1, m)) if s == S - 1 \
            else b_slot.get((s + 1, v, m))
        return None if prod is None else max(own + 1, prod + 1)

    actions, done_b, u = [], 0, 0
    limit = 4 * (total + S * V) + 16 * S + 64
    while done_b < S * total:
        if u >= limit:
            raise AssertionError(
                f"interleaved schedule deadlocked at slot {u} "
                f"(S={S} V={V} M={M})")
        row = []
        for s in range(S):
            nf = fwd_q[s][0] if fwd_q[s] else None
            nb = bwd_q[s][0] if bwd_q[s] else None
            fa = f_arrival(s, *nf) if nf else None
            ba = b_arrival(s, *nb) if nb else None
            f_ready = fa is not None and fa <= u
            b_ready = ba is not None and ba <= u
            f_done = total - len(fwd_q[s])
            in_flight = f_done - (total - len(bwd_q[s]))
            if f_done < warm(s):
                choice = "f" if f_ready else None
            elif in_flight < warm(s):
                choice = "f" if f_ready else ("b" if b_ready else None)
            else:
                choice = "b" if b_ready else ("f" if f_ready else None)
            if choice == "f":
                v, m = fwd_q[s].pop(0)
                f_slot[(s, v, m)] = u
                row.append((0, v, m))
            elif choice == "b":
                v, m = bwd_q[s].pop(0)
                b_slot[(s, v, m)] = u
                done_b += 1
                row.append((1, v, m))
            else:
                row.append((2, 0, 0))
        actions.append(row)
        u += 1

    U = len(actions)

    # Activation-stash and cotangent-buffer lifetimes per (device,
    # chunk); ring depth = max concurrent lifetimes, then the m -> m %
    # depth mapping is checked collision-free.
    def ring_depth(intervals_by_chunk, what):
        depth = 1
        for ivs in intervals_by_chunk.values():
            for t in range(U):
                depth = max(depth, sum(1 for (a, b, _) in ivs
                                       if a <= t <= b))
        while True:
            ok = True
            for ivs in intervals_by_chunk.values():
                for i, (a, b, m) in enumerate(ivs):
                    for (a2, b2, m2) in ivs[i + 1:]:
                        if m % depth == m2 % depth and a <= b2 and a2 <= b:
                            ok = False
            if ok:
                return depth
            depth += 1
            if depth > M:
                raise AssertionError(f"no collision-free {what} ring "
                                     f"depth <= M (S={S} V={V} M={M})")

    stash_iv, ctg_iv = {}, {}
    for (s, v, m), bs in b_slot.items():
        fs = f_slot[(s, v, m)]
        if s == 0 and v == 0:
            a_w = fs
        else:
            prod = f_slot[(s - 1, v, m)] if s > 0 \
                else f_slot[(S - 1, v - 1, m)]
            a_w = prod + 1
        stash_iv.setdefault((s, v), []).append((a_w, bs, m))
        if s == S - 1 and v == V - 1:
            c_w = fs
        else:
            prod = b_slot[(0, v + 1, m)] if s == S - 1 \
                else b_slot[(s + 1, v, m)]
            c_w = prod + 1
        ctg_iv.setdefault((s, v), []).append((c_w, bs, m))
    Q = ring_depth(stash_iv, "activation")
    Qb = ring_depth(ctg_iv, "cotangent")

    kind = np.full((U, S), 2, np.int32)
    chunk = np.zeros((U, S), np.int32)
    mb = np.zeros((U, S), np.int32)
    stash_idx = np.zeros((U, S), np.int32)
    ctg_idx = np.zeros((U, S), np.int32)
    rf_valid = np.zeros((U, S), np.int32)
    rf_idx = np.zeros((U, S), np.int32)
    rb_valid = np.zeros((U, S), np.int32)
    rb_idx = np.zeros((U, S), np.int32)
    for t, row in enumerate(actions):
        for s, (k, v, m) in enumerate(row):
            last_global = s == S - 1 and v == V - 1
            kind[t, s] = 3 if (k == 0 and last_global) else k
            chunk[t, s], mb[t, s] = v, m
            stash_idx[t, s] = v * Q + m % Q
            ctg_idx[t, s] = v * Qb + m % Qb
            if k == 0 and not last_global:
                sc, vc = ((s + 1, v) if s < S - 1 else (0, v + 1))
                rf_valid[t + 1, sc] = 1
                rf_idx[t + 1, sc] = vc * Q + m % Q
            if k == 1 and not (s == 0 and v == 0):
                sc, vc = ((s - 1, v) if s > 0 else (S - 1, v - 1))
                rb_valid[t + 1, sc] = 1
                rb_idx[t + 1, sc] = vc * Qb + m % Qb
    head_rows, head_cols = np.nonzero(kind == 3)
    assert (head_cols == S - 1).all() and len(head_rows) == M, \
        f"loss-head subticks misplaced (S={S} V={V} M={M})"
    return InterleavedSchedule(
        S=S, V=V, M=M, n_slots=U, stash_depth=Q, ctg_depth=Qb,
        kind=kind, chunk=chunk, mb=mb, stash_idx=stash_idx,
        ctg_idx=ctg_idx, rf_valid=rf_valid, rf_idx=rf_idx,
        rb_valid=rb_valid, rb_idx=rb_idx)


def _chunk_permutation(n_layers, S, V):
    """Row permutation taking the canonical stacked-layer order to the
    device-major interleaved order (device ``s`` holds global stages
    ``v*S + s`` as ``V`` contiguous blocks), and its inverse."""
    if n_layers % (S * V):
        raise ValueError(f"stacked layer axis {n_layers} must divide "
                         f"into {S} stages x {V} virtual chunks")
    lb = n_layers // (S * V)
    perm = np.concatenate([np.arange(lb) + (v * S + s) * lb
                           for s in range(S) for v in range(V)])
    return perm, np.argsort(perm)


def stash_depth(S, M):
    """Lockstep 1F1B's stash depth a stage: ``Q = min(M, 2S - 1)``."""
    return min(M, 2 * S - 1)


# The slot plans the engine walks: plan[u][s] is the list of (op, v, m)
# stage s runs at slot u, in order.

def gpipe_plan(S, M, V=1):
    """Forwards only: global stage ``g = v * S + s`` forwards microbatch
    ``m`` at slot ``g + m`` (JAX's gpipe at V = 1: ``M + S - 1`` slots)."""
    G = S * V
    plan = [[[] for _ in range(S)] for _ in range(M + G - 1)]
    for g in range(G):
        v, s = divmod(g, S)
        for m in range(M):
            plan[g + m][s].append((_F, v, m))
    return plan


def drain_plan(S, M, V=1):
    """gpipe's backwards in reverse: global stage ``g`` runs microbatch
    ``m``'s backward at slot ``(G - 1 - g) + (M - 1 - m)``."""
    G = S * V
    plan = [[[] for _ in range(S)] for _ in range(M + G - 1)]
    for g in reversed(range(G)):
        v, s = divmod(g, S)
        for m in reversed(range(M)):
            plan[(G - 1 - g) + (M - 1 - m)][s].append((_B, v, m))
    return plan


def lockstep_plan(S, M):
    """Lockstep 1F1B (JAX's ``one_f_one_b``): ``M + 2(S-1)`` slots, each
    stage's forward subtick then its backward subtick."""
    plan = []
    for u in range(M + 2 * (S - 1)):
        row = []
        for s in range(S):
            acts = []
            if 0 <= u - s < M:
                acts.append((_F, 0, u - s))
            m_b = u - (2 * (S - 1) - s)
            if 0 <= m_b < M:
                acts.append((_B, 0, m_b))
            row.append(acts)
        plan.append(row)
    return plan


def interleaved_plan(sched):
    """The single-subtick slots of :func:`build_interleaved_schedule`'s
    tables (kind 2 idle, kinds 0 and 3 forwards, 1 backwards)."""
    return [[[] if k == 2 else [(_B if k == 1 else _F, int(v), int(m))]
             for k, v, m in zip(sched.kind[u], sched.chunk[u], sched.mb[u])]
            for u in range(sched.n_slots)]


def _next(s, v, S, V):
    """Where (stage s, chunk v)'s forward output goes (None: the last
    global stage)."""
    if s < S - 1:
        return s + 1, v
    return (0, v + 1) if v < V - 1 else None


def _prev(s, v, S, V):
    """Where (stage s, chunk v)'s input cotangent goes (None: the first
    global stage, whose is ``d_xs``)."""
    if s > 0:
        return s - 1, v
    return (S - 1, v - 1) if v > 0 else None


# ---- transports -------------------------------------------------------------

class InProcessTransport:
    """All ``S`` stages in this process: a message is handed over, a
    value held by one stage is that stage's, a sum is over the stages
    in order."""

    def __init__(self, S):
        if S < 1:
            raise ValueError(f"need S >= 1 stages, got {S}")
        self.S = int(S)

    def is_local(self, s):
        return True

    def chunk_start(self, s, v, V, lb):
        """Row of chunk (s, v) in a canonical stacked leaf."""
        return (v * self.S + s) * lb

    def leaf_rows(self, V, lb):
        return self.S * V * lb

    def exchange(self, sends, recvs, like):
        return {key: y for _, key, y in sends}

    def share(self, values, src, like):
        return values[src]

    def total(self, values):
        out = None
        for s in sorted(values):
            out = values[s] if out is None else out + values[s]
        return out


class MeshTransport:
    """This rank's stage of the mesh's ``pipe`` axis: messages are P2P
    over the axis's group (each slot's one ``batch_isend_irecv``), a
    stage's value is broadcast from it, a sum is an all-reduce. Built by
    :func:`mesh_transport`, collectively over the axis."""

    def __init__(self, mesh):
        self.S = mesh.shape["pipe"]
        self.stage = mesh.axis_index("pipe")
        self.group = mesh.axis_group("pipe")
        if self.group is None:
            raise ValueError("the 'pipe' axis has size 1: no pipeline")
        self.ranks = dist.get_process_group_ranks(self.group)
        self.device = mesh.device
        # A group's first P2P must not be its first op (NCCL creates the
        # communicator at a collective every member joins).
        warm = torch.zeros(1, device=mesh.device)
        dist.all_reduce(warm, group=self.group)

    def is_local(self, s):
        return s == self.stage

    def chunk_start(self, s, v, V, lb):
        """Row of chunk v in this rank's device-major block."""
        return v * lb

    def leaf_rows(self, V, lb):
        return V * lb

    def _wait(self, works):
        for w in works:
            if self.device.type == "cpu":
                w.wait(_TIMEOUT)
            else:
                w.wait()

    def exchange(self, sends, recvs, like):
        got, ops = {}, []
        for dst, key, y in sends:
            if self.is_local(dst):
                got[key] = y
            else:
                ops.append(dist.P2POp(dist.isend, y.contiguous(),
                                      self.ranks[dst], self.group))
        for src, key in recvs:
            buf = torch.empty_like(like)
            got[key] = buf
            ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                  self.group))
        if ops:
            self._wait(dist.batch_isend_irecv(ops))
        return got

    def share(self, values, src, like):
        out = values[src].contiguous() if self.stage == src \
            else torch.empty_like(like)
        self._wait([dist.broadcast(out, self.ranks[src], group=self.group,
                                   async_op=True)])
        return out

    def total(self, values):
        out = values[self.stage].clone()
        self._wait([dist.all_reduce(out, group=self.group, async_op=True)])
        return out


def mesh_transport(mesh):
    """The mesh's :class:`MeshTransport` (made once a mesh, collectively
    over the ``pipe`` axis)."""
    t = getattr(mesh, "_pipe_transport", None)
    if t is None:
        t = MeshTransport(mesh)
        mesh._pipe_transport = t
    return t


# ---- the slot walker --------------------------------------------------------

def _walk(plan, transport, V, like, on_forward, on_backward):
    """Run ``plan`` on the transport's local stages. ``on_forward(s, v,
    m, x)`` gets the input arrived for (s, v, m) (None for the first
    global stage) and returns what to send on (ignored at the last global
    stage); ``on_backward(s, v, m, g)`` gets the cotangent arrived (None
    at the last global stage, whose own forward made it) and returns
    what to send up (ignored at the first). After each slot every
    message crosses its stage boundary; a stage with nothing to send or
    receive in a slot does neither."""
    S = transport.S
    inbox = {}
    for row in plan:
        sends, recvs = [], []
        for s in range(S):
            local = transport.is_local(s)
            for op, v, m in row[s]:
                if op == _F:
                    dst, tag = _next(s, v, S, V), "f"
                    if local:
                        out = on_forward(s, v, m, inbox.pop(("f", s, v, m),
                                                            None))
                else:
                    dst, tag = _prev(s, v, S, V), "b"
                    if local:
                        out = on_backward(s, v, m, inbox.pop(("b", s, v, m),
                                                             None))
                if dst is None:
                    continue
                key = (tag, dst[0], dst[1], m)
                if local:
                    sends.append((dst[0], key, out))
                elif transport.is_local(dst[0]):
                    recvs.append((s, key))
        inbox.update(transport.exchange(sends, recvs, like))
    if inbox:
        raise AssertionError(f"undelivered pipeline messages: {list(inbox)}")


class _Chunks:
    """The local chunks of ``stage_params`` as trees of ``[Lb, ...]``
    leaves (views), and their gradients put back in the leaves' layout."""

    def __init__(self, stage_params, transport, V):
        self.tree = stage_params
        self.leaves = tree_leaves(stage_params)
        if not self.leaves:
            raise ValueError("empty stage_params")
        self.transport, self.V = transport, V
        n = self.leaves[0].shape[0]
        per = transport.leaf_rows(V, 1)
        if n % per:
            raise ValueError(f"stacked layer axis {n} must divide into "
                             f"{per} pipeline chunks")
        self.lb = n // per

    def local(self):
        return [(s, v) for s in range(self.transport.S)
                if self.transport.is_local(s) for v in range(self.V)]

    def leaves_of(self, s, v, detach=False):
        start = self.transport.chunk_start(s, v, self.V, self.lb)
        out = [w.narrow(0, start, self.lb) for w in self.leaves]
        if detach:
            out = [w.detach().requires_grad_(w.is_floating_point())
                   for w in out]
        return out

    def tree_of(self, leaves):
        return tree_unflatten(self.tree, leaves)

    def assemble(self, grads):
        """Leaf-shaped gradients from ``grads[(s, v)]`` (lists of chunk
        gradients), chunks placed where their rows lie."""
        out = []
        for i, w in enumerate(self.leaves):
            full = torch.zeros_like(w)
            for (s, v), gs in grads.items():
                start = self.transport.chunk_start(s, v, self.V, self.lb)
                full.narrow(0, start, self.lb).copy_(gs[i])
            out.append(full)
        return out


def _add(acc, gs):
    """Accumulate a list of gradients in their own dtype (JAX's ``acc +
    g`` from zeros: the first is taken as is)."""
    if acc is None:
        return list(gs)
    return [a + g for a, g in zip(acc, gs)]


def _grads(outputs, cotangents, inputs):
    """``torch.autograd.grad`` of the outputs that carry a graph (a dense
    stage's aux is a constant), zeros for inputs nothing reached."""
    pairs = [(o, g) for o, g in zip(outputs, cotangents) if o.requires_grad]
    if not pairs:
        return [torch.zeros_like(x) for x in inputs]
    got = torch.autograd.grad([o for o, _ in pairs], inputs,
                              [g for _, g in pairs], allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(got, inputs)]


def _check_stages(transport, M):
    if M < 1:
        raise ValueError(f"need at least one microbatch, got {M}")
    return transport.S


# ---- gpipe ------------------------------------------------------------------

class _GPipeRun:
    """One gpipe call: the forwards (graphs kept when training) and the
    drain."""

    def __init__(self, stage_fn, stage_params, xs, transport, V):
        self.stage_fn, self.transport, self.V = stage_fn, transport, V
        self.S = _check_stages(transport, xs.shape[0])
        self.M = xs.shape[0]
        self.chunks = _Chunks(stage_params, transport, V)

    def forward(self, xs, train):
        S, V, M = self.S, self.V, self.M
        ys, aux, saved = {}, {}, {}
        live = {c: self.chunks.leaves_of(*c, detach=train)
                for c in self.chunks.local()}

        def on_forward(s, v, m, x):
            first = s == 0 and v == 0
            x = xs[m] if first else x
            with torch.enable_grad() if train else torch.no_grad():
                if train:
                    x = x.detach().requires_grad_(True)
                y, a = self.stage_fn(self.chunks.tree_of(live[(s, v)]), x)
            if train:
                saved[(s, v, m)] = (x, y, a)
            aux[s] = a.detach().float() if s not in aux \
                else aux[s] + a.detach().float()
            if s == S - 1 and v == V - 1:
                ys[m] = y.detach()
            return y.detach()

        _walk(gpipe_plan(S, M, V), self.transport, V, xs[0], on_forward,
              None)
        last = {S - 1: torch.stack([ys[m] for m in range(M)])} \
            if self.transport.is_local(S - 1) else {}
        out = self.transport.share(last, S - 1, xs)
        aux_total = self.transport.total(aux)
        self.saved, self.live, self.xs = saved, live, xs.detach()
        return out, aux_total

    def backward(self, g_ys, g_aux):
        S, V, M = self.S, self.V, self.M
        d_xs, grads = {}, {}
        g_aux = g_aux.float().reshape(())

        def on_backward(s, v, m, g):
            x, y, a = self.saved.pop((s, v, m))
            if g is None:
                g = g_ys[m].to(y.dtype)
            leaves = self.live[(s, v)]
            dx, *dp = _grads([y, a], [g, g_aux], [x, *leaves])
            grads[(s, v)] = _add(grads.get((s, v)), dp)
            if s == 0 and v == 0:
                d_xs[m] = dx
            return dx

        _walk(drain_plan(S, M, V), self.transport, V, g_ys[0],
              None, on_backward)
        first = {0: torch.stack([d_xs[m] for m in range(M)])} \
            if self.transport.is_local(0) else {}
        d_xs = self.transport.share(first, 0, self.xs)
        return d_xs, self.chunks.assemble(grads)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, xs, *leaves):
        ctx.run = run
        return run.forward(xs, train=True)

    @staticmethod
    def backward(ctx, g_ys, g_aux):
        d_xs, d_leaves = ctx.run.backward(g_ys, g_aux)
        ctx.run = None
        return (None, d_xs, *d_leaves)


def gpipe(stage_fn, stage_params, xs, transport, num_virtual=1):
    """Run microbatches ``xs`` [M, ...] through the pipeline.

    ``stage_fn(chunk_params, x_mb) -> (y_mb, aux)`` applies one chunk of
    the network (aux a scalar, e.g. an MoE balance loss; a constant
    zero if unused). Returns ``(ys [M, ...], aux_sum)`` on every stage,
    aux_sum the f32 total over every (chunk, microbatch). With
    ``num_virtual`` V > 1 each stage holds V chunks and global stage
    ``v * S + s`` forwards microbatch ``m`` at slot ``v * S + s + m``.
    Differentiable: under autograd (a leaf or ``xs`` requiring grad) the
    forwards keep their graphs and the backward drains them in reverse."""
    V = int(num_virtual)
    run = _GPipeRun(stage_fn, stage_params, xs, transport, V)
    leaves = run.chunks.leaves
    if torch.is_grad_enabled() and (xs.requires_grad or any(
            w.requires_grad for w in leaves)):
        return _GPipe.apply(run, xs, *leaves)
    with torch.no_grad():
        return run.forward(xs, train=False)


# ---- 1F1B -------------------------------------------------------------------

def _fused(plan, stage_fn, loss_fn, stage_params, head_params, xs,
           loss_args, transport, V, aux_cotangent, bound=None):
    """The fused forward/backward engine of both 1F1B schedules: walk
    ``plan``; a forward subtick stashes its input and runs the chunk
    without a graph (the last global stage also runs the loss head: the
    microbatch loss, its cotangent and the head-param gradients from one
    backward of the head); a backward subtick re-runs the chunk from its
    stashed input under autograd and pulls the cotangent through it.
    ``bound`` is the most inputs a stage may hold stashed at once."""
    S = _check_stages(transport, xs.shape[0])
    M = xs.shape[0]
    chunks = _Chunks(stage_params, transport, V)
    head = [h.detach() for h in head_params]
    stash, ctg, aux, grads, d_xs = {}, {}, {}, {}, {}
    acc = {"loss": None, "d_hp": None}
    aux_g = torch.tensor(float(aux_cotangent), dtype=torch.float32,
                         device=xs.device)

    def on_forward(s, v, m, x):
        x = xs[m].detach() if s == 0 and v == 0 else x
        stash[(s, v, m)] = x
        if bound is not None:
            held = sum(1 for k in stash if k[0] == s)
            if held > bound:
                raise AssertionError(f"stage {s} holds {held} stashed "
                                     f"inputs, more than {bound}")
        with torch.no_grad():
            y, a = stage_fn(chunks.tree_of(chunks.leaves_of(s, v)), x)
        aux[s] = a.float() if s not in aux else aux[s] + a.float()
        if s == S - 1 and v == V - 1:
            la = [t[m] for t in loss_args]
            with torch.enable_grad():
                yg = y.detach().requires_grad_(True)
                hp = [h.requires_grad_(h.is_floating_point())
                      for h in (w.detach() for w in head)]
                lval = loss_fn(hp, yg, la)
                g_last, *d_hp = _grads([lval], [torch.ones_like(lval)],
                                       [yg, *hp])
            acc["loss"] = lval.detach().float() if acc["loss"] is None \
                else acc["loss"] + lval.detach().float()
            acc["d_hp"] = _add(acc["d_hp"], d_hp)
            ctg[(s, v, m)] = g_last
        return y

    def on_backward(s, v, m, g):
        g = ctg.pop((s, v, m)) if g is None else g
        x = stash.pop((s, v, m))
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            leaves = chunks.leaves_of(s, v, detach=True)
            y, a = stage_fn(chunks.tree_of(leaves), xg)
            dx, *dp = _grads([y, a], [g, aux_g], [xg, *leaves])
        grads[(s, v)] = _add(grads.get((s, v)), dp)
        if s == 0 and v == 0:
            d_xs[m] = dx
        return dx

    _walk(plan, transport, V, xs[0], on_forward, on_backward)
    last, first = S - 1, 0
    zero = torch.zeros((), dtype=torch.float32, device=xs.device)
    loss = transport.share({last: acc["loss"]} if transport.is_local(last)
                           else {}, last, zero)
    d_hp = [transport.share({last: acc["d_hp"][i]} if transport.is_local(
        last) else {}, last, h) for i, h in enumerate(head)]
    d_x = transport.share({first: torch.stack([d_xs[m] for m in range(M)])}
                          if transport.is_local(first) else {}, first, xs)
    aux_total = transport.total({s: aux.get(s, zero) for s in range(S)
                                 if transport.is_local(s)})
    return loss, aux_total, chunks.assemble(grads), d_hp, d_x


def one_f_one_b(stage_fn, loss_fn, stage_params, head_params, xs, loss_args,
                transport, aux_cotangent=0.0):
    """Lockstep 1F1B (JAX's ``one_f_one_b``): forward and backward
    subticks in each of ``M + 2(S-1)`` slots, the loss computed on the
    last stage per microbatch, at most ``min(M, 2S - 1)`` stashed inputs
    a stage. ``loss_fn(head_params, y_mb, loss_args_mb) -> scalar`` is
    the last stage's per-microbatch objective NUMERATOR (a global
    normalisation folded in by the caller); ``loss_args`` a sequence of
    tensors with leading axis M; ``aux_cotangent`` the constant
    d(objective)/d(aux) of every aux contribution.

    Returns ``(loss_sum, aux_sum, d_stage_params, d_head_params, d_xs)``:
    the gradient of ``loss_sum + aux_cotangent * aux_sum`` (plain
    tensors, no graph), ``d_stage_params`` a tree like
    ``stage_params``, ``d_head_params`` a list like ``head_params``."""
    S, M = transport.S, xs.shape[0]
    loss, aux, d_sp, d_hp, d_xs = _fused(
        lockstep_plan(S, M), stage_fn, loss_fn, stage_params, head_params,
        xs, loss_args, transport, 1, aux_cotangent, bound=stash_depth(S, M))
    return loss, aux, tree_unflatten(stage_params, d_sp), d_hp, d_xs


def interleaved_one_f_one_b(stage_fn, loss_fn, stage_params, head_params,
                            xs, loss_args, transport, num_virtual=1,
                            aux_cotangent=0.0):
    """Interleaved (virtual-stage) 1F1B (JAX's
    ``interleaved_one_f_one_b``): each stage holds ``V`` chunks (global
    stage ``v * S + s``), every slot one subtick a stage, chosen by
    :func:`build_interleaved_schedule`'s tables; ``num_virtual=1`` is the
    true non-interleaved 1F1B. Same contract as :func:`one_f_one_b`
    (``stage_fn`` receives a chunk); ``d_stage_params`` comes back in
    ``stage_params``' layout."""
    S, M, V = transport.S, xs.shape[0], int(num_virtual)
    sched = build_interleaved_schedule(S, V, M)
    loss, aux, d_sp, d_hp, d_xs = _fused(
        interleaved_plan(sched), stage_fn, loss_fn, stage_params,
        head_params, xs, loss_args, transport, V, aux_cotangent,
        bound=V * sched.stash_depth)
    return loss, aux, tree_unflatten(stage_params, d_sp), d_hp, d_xs


# ---- static-analysis hooks (hvdlint) ----------------------------------------

def build_pipeline_inner(schedule, stage_fn, loss_fn=None, *, S, M,
                         num_virtual=1, transport, aux_cotangent=0.0):
    """A schedule bound to ``transport`` as the program hvdlint runs
    (JAX's ``build_pipeline_inner``, whose inner is the per-device
    program of ``_pipe_spmd``): ``inner(sp, xs)`` for ``"gpipe"`` (its
    forward, with no graph, as JAX's gpipe inner; one chunk a stage),
    ``inner(sp, hp, xs, largs)`` for the 1F1B schedules, which need
    ``loss_fn``. ``S`` and ``M`` are checked against the transport and
    the microbatches."""
    if transport.S != S:
        raise ValueError(f"the transport has {transport.S} stages, not {S}")

    def check(xs):
        if xs.shape[0] != M:
            raise ValueError(f"xs has {xs.shape[0]} microbatches, not {M}")

    if schedule == "gpipe":
        def inner(sp, xs):
            check(xs)
            with torch.no_grad():
                return gpipe(stage_fn, sp, xs, transport)
        return inner
    if loss_fn is None:
        raise ValueError(f"schedule {schedule!r} requires loss_fn")
    if schedule == "1f1b":
        def inner(sp, hp, xs, largs):
            check(xs)
            return one_f_one_b(stage_fn, loss_fn, sp, hp, xs, largs,
                               transport, aux_cotangent=aux_cotangent)
        return inner
    if schedule == "interleaved_1f1b":
        def inner(sp, hp, xs, largs):
            check(xs)
            return interleaved_one_f_one_b(
                stage_fn, loss_fn, sp, hp, xs, largs, transport,
                num_virtual=num_virtual, aux_cotangent=aux_cotangent)
        return inner
    raise ValueError(f"unknown schedule {schedule!r}: expected one of "
                     f"{SCHEDULES}")


def _stage_exchanges(plan, S, V, stage):
    """How many ``ppermute`` records each slot of ``plan`` gives
    ``stage``: the slot's one ``batch_isend_irecv`` carries its sends
    and receives, the recorder's rule pairs them (one record a send, a
    receive where receives outnumber sends), and a slot with nothing to
    exchange gives none."""
    out = []
    for row in plan:
        sends = recvs = 0
        for s in range(S):
            for op, v, _ in row[s]:
                dst = _next(s, v, S, V) if op == _F else _prev(s, v, S, V)
                if dst is None or dst[0] == s:
                    continue
                sends += s == stage
                recvs += dst[0] == stage
        out.append(max(sends, recvs))
    return out


def predicted_collectives(schedule, *, S, M, num_virtual=1, axis="pipe",
                          n_head_leaves=2, stage=0):
    """The ordered collective sequence stage ``stage`` of a schedule's
    program (:func:`build_pipeline_inner`) MUST issue, from the slot
    plans the engine walks: the ground truth of hvdlint's C5.

    - gpipe (the forward): a ``ppermute`` a slot this stage exchanges in
      (:func:`gpipe_plan`), then the ``psum`` pair sharing the outputs
      from the last stage and summing the aux;
    - 1f1b (:func:`lockstep_plan`) and interleaved_1f1b
      (:func:`interleaved_plan` of :func:`build_interleaved_schedule`,
      the table the engine runs): a ``ppermute`` a slot exchange, then
      the shared loss, the ``n_head_leaves`` head gradients and ``d_xs``
      (each a broadcast from its stage: a masked ``psum`` in JAX's
      vocabulary) and the aux sum.

    Where JAX's prediction has a ring hop every slot (its scan computes
    on garbage in a bubble and masks it), the port's skips the slots the
    stage exchanges nothing in, and exchanges a slot's forward and
    backward messages in one batch. Returns ``[(prim, (axis,)), ...]``."""
    V = int(num_virtual)
    pp, ps = ("ppermute", (axis,)), ("psum", (axis,))
    if schedule == "gpipe":
        plan, V, tail = gpipe_plan(S, M), 1, 2
    elif schedule == "1f1b":
        plan, V, tail = lockstep_plan(S, M), 1, n_head_leaves + 3
    elif schedule == "interleaved_1f1b":
        plan = interleaved_plan(build_interleaved_schedule(S, V, M))
        tail = n_head_leaves + 3
    else:
        raise ValueError(f"unknown schedule {schedule!r}: expected one of "
                         f"{SCHEDULES}")
    return [pp] * sum(_stage_exchanges(plan, S, V, stage)) + [ps] * tail
