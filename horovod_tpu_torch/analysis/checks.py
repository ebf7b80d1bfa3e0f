"""The hvdlint check catalog (C1-C3, C5-C8) over a recorded program.

The port's own copy of ``horovod_tpu/analysis/checks.py``. Each check is
a pure function ``(extraction, context) -> [Diagnostic]``; :func:`run_all`
applies every shipped one. C1 and C8 compare the checked ranks'
sequences; the others read the first checked rank's, as JAX's read its
one program. C4 (donation) has no counterpart: eager PyTorch donates no
buffers.
"""

import collections

from horovod_tpu_torch.analysis import diagnostics as D
from horovod_tpu_torch.analysis.extract import iter_nodes, linearize

#: the reduce-scatter primitive's spellings (JAX's two, across versions)
_SCATTER_PRIMS = ("psum_scatter", "reduce_scatter")


def _collapse(seq, max_period=8):
    """``seq`` with every run of a repeated block (up to ``max_period``
    items) folded to one block: the same loop run a different number of
    times folds to the same sequence."""
    seq = list(seq)
    while True:
        before = len(seq)
        for p in range(1, max_period + 1):
            out, i = [], 0
            while i < len(seq):
                block = seq[i:i + p]
                j = i + p
                while len(block) == p and seq[j:j + p] == block:
                    j += p
                if j > i + p:
                    out.extend(block)
                    i = j
                else:
                    out.append(seq[i])
                    i += 1
            seq = out
        if len(seq) == before:
            return tuple(seq)


def _group_sequences(ex):
    """group ranks -> {rank: [Collective, ...]} of every non-P2P
    collective the checked ranks issued on that group."""
    groups = collections.defaultdict(dict)
    for rank, colls in ex.per_rank.items():
        for c in colls:
            if c.prim == "ppermute":
                continue
            groups[c.ranks].setdefault(rank, []).append(c)
    for ranks, by_rank in groups.items():
        for r in ex.per_rank:
            if r in ranks:
                by_rank.setdefault(r, [])
    return groups


def _origin(ex):
    """Where a difference between the ranks comes from."""
    if ex.same_inputs:
        return ("every rank ran on the same inputs, so the difference "
                "derives from the rank (mesh.axis_index / dist.get_rank)")
    return "the ranks' inputs differ"


def _first_mismatch(a, b):
    n = min(len(a), len(b))
    for i in range(n):
        if a[i].key != b[i].key:
            return i
    return n


def _describe(c):
    if c is None:
        return "nothing"
    return f"{c.prim}{list(c.axes)} {c.dtype}[{c.nelems}]"


def check_collective_divergence(ex, ctx):
    """C1: two checked ranks issue different collective sequences on a
    group they both belong to, or a send finds no matching receive.

    Under SPMD every member of a group must issue the SAME ordered
    collective sequence on it; the first rank to issue something else
    deadlocks the group. A divergence that is only a repeat count of the
    same collectives is C8's, not C1's."""
    out = []
    for ranks, by_rank in sorted(_group_sequences(ex).items()):
        members = sorted(by_rank)
        base = members[0]
        for other in members[1:]:
            a, b = by_rank[base], by_rank[other]
            if [c.key for c in a] == [c.key for c in b]:
                continue
            if _collapse(c.key for c in a) == _collapse(c.key for c in b):
                continue   # a repeat count: C8
            i = _first_mismatch(a, b)
            ca = a[i] if i < len(a) else None
            cb = b[i] if i < len(b) else None
            site = ca or cb
            out.append(D.make(
                "C1", site.path,
                f"ranks {base} and {other} issue different collective "
                f"sequences on the group of ranks {list(ranks)} "
                f"({len(a)}/{len(b)} collectives): first divergence at "
                f"#{i}, rank {base} issues {_describe(ca)}, rank {other} "
                f"{_describe(cb)}; {_origin(ex)}: "
                + ("ranks WILL issue different sequences" if ex.same_inputs
                   else "any cross-rank disagreement on what to issue "
                        "deadlocks"),
                hint="hoist collectives out of rank- or data-dependent "
                     "branches (compute masked contributions and reduce "
                     "unconditionally), or make every branch issue the "
                     "identical sequence",
                source=site.source))
            break
    out.extend(_p2p_divergence(ex))
    return out


def _p2p_divergence(ex):
    """Every send from rank a to rank b must meet a receive at b from a,
    in order, of the same size and dtype (for the checked ranks)."""
    sent = collections.defaultdict(list)
    got = collections.defaultdict(list)
    for rank, colls in ex.per_rank.items():
        for c in colls:
            if c.send is not None:
                sent[(rank, c.send[0])].append((c.send[1:], c))
            if c.recv is not None:
                got[(c.recv[0], rank)].append((c.recv[1:], c))
    out = []
    for a, b in sorted(set(sent) | set(got)):
        if a not in ex.per_rank or b not in ex.per_rank:
            continue
        s = [m for m, _ in sent.get((a, b), [])]
        r = [m for m, _ in got.get((a, b), [])]
        if s == r:
            continue
        site = (sent.get((a, b)) or got.get((a, b)))[0][1]
        out.append(D.make(
            "C1", site.path,
            f"rank {a} sends rank {b} {len(s)} message(s) {s[:3]} but rank "
            f"{b} posts {len(r)} receive(s) from it {r[:3]}: a "
            "point-to-point exchange with no partner deadlocks",
            hint="pair every send with a receive of the same shape on the "
                 "peer, in the same order",
            source=site.source))
    return out


def check_axis_validity(ex, ctx):
    """C2: collectives over a group that is no declared mesh axis, or
    not of its size.

    ``mesh_axes`` of ``None`` means the caller declared nothing at all
    (no mesh, no axis_env) and the program issued no collective: no
    ground truth, skip. An EMPTY declared set flags every collective."""
    mesh_axes = ctx.get("mesh_axes")
    if mesh_axes is None:
        return []
    declared = set(mesh_axes)
    sizes = ctx.get("axis_sizes") or {}
    out = []
    for node in iter_nodes(ex.signature):
        unknown = [a for a in node.axes if a not in declared]
        if unknown:
            out.append(D.make(
                "C2", node.path,
                f"{node.prim} over {unknown} (the group of ranks "
                f"{list(node.ranks)}) not in the declared mesh axes "
                f"{sorted(declared)}",
                hint="issue the collective over a mesh axis's group "
                     "(Mesh.axis_group / axes_group), or declare the axis",
                source=node.source))
            continue
        want = 1
        for a in node.axes:
            want *= sizes.get(a, 1)
        if sizes and len(node.ranks) != want:
            out.append(D.make(
                "C2", node.path,
                f"{node.prim} over axes {list(node.axes)} on a group of "
                f"{len(node.ranks)} ranks, but the mesh declares {want}",
                hint="build the groups from the mesh the program is "
                     "linted with",
                source=node.source))
    return out


def check_width_waste(ex, ctx):
    """C3: f32 reductions of data cast up from bf16/f16 whose result is
    used at f32 — the wire carries twice the bytes the data holds. The
    round trip (cast up, reduce, cast straight back down) is exempt."""
    out = []
    for node in iter_nodes(ex.signature):
        if node.upcast_from and not node.roundtrip:
            out.append(D.make(
                "C3", node.path,
                f"{node.prim} reduces float32 data upcast from "
                f"{node.upcast_from} ({node.nelems} elements) and the "
                f"result stays float32",
                hint=f"reduce in {node.upcast_from} (the lane's compressed "
                     "wire is the cheap win), or cast the result straight "
                     f"back to {node.upcast_from} if f32 was only for "
                     "accumulation",
                source=node.source))
    return out


def check_schedule_conformance(ex, ctx):
    """C5: the recorded collective sequence must equal the host-side
    prediction (``expect_collectives``: ``parallel.pipeline.
    predicted_collectives`` for a schedule, ``parallel.ops.
    predicted_hier_collectives`` / ``predicted_zero_collectives``, or
    ``ReshardPlan.expected_collectives``). Both reduce-scatter spellings
    compare equal."""
    expected = ctx.get("expect_collectives")
    if expected is None:
        return []

    def norm(p):
        return "reduce_scatter" if p in _SCATTER_PRIMS else p

    actual = [(norm(c.prim), tuple(c.axes))
              for c in linearize(ex.signature)]
    expected = [(norm(p), tuple(a) if isinstance(a, (tuple, list))
                 else (a,))
                for p, a in expected]
    if actual == expected:
        return []
    msg = _first_divergence(actual, expected)
    return [D.make(
        "C5", "<program>",
        f"collective sequence deviates from the schedule table's "
        f"prediction: {msg}",
        hint="the engine and its host schedule builder disagree — "
             "either the schedule table changed without the engine "
             "(or vice versa), or an extra/missing collective crept "
             "into the stage/loss functions")]


def _first_divergence(actual, expected):
    n = min(len(actual), len(expected))
    for i in range(n):
        if actual[i] != expected[i]:
            return (f"first divergence at collective #{i}: recorded "
                    f"{actual[i]}, predicted {expected[i]} "
                    f"(recorded {len(actual)} vs predicted "
                    f"{len(expected)} total)")
    return (f"recorded {len(actual)} collectives vs predicted "
            f"{len(expected)} (prefix matches)")


def check_shard_collective_pairing(ex, ctx):
    """C6: every reduce-scatter must pair with an all-gather over the
    SAME axes, at or after it in issue order (the ZeRO invariant:
    scatter grads, update shards, gather params). A gather before the
    scatter cannot reassemble its result and does not count."""
    pending = collections.Counter()   # axes -> scatters awaiting gather
    total = collections.Counter()
    sites = {}
    for c in linearize(ex.signature):
        if c.prim in _SCATTER_PRIMS:
            pending[c.axes] += 1
            total[c.axes] += 1
            sites.setdefault(c.axes, c)
        elif c.prim == "all_gather" and pending.get(c.axes, 0) > 0:
            pending[c.axes] -= 1
    out = []
    for axes, n_unpaired in sorted(pending.items()):
        if n_unpaired <= 0:
            continue
        site = sites[axes]
        out.append(D.make(
            "C6", site.path,
            f"{total[axes]} reduce-scatter(s) over axis {list(axes)} "
            f"but only {total[axes] - n_unpaired} subsequent "
            f"allgather(s) on that axis — {n_unpaired} shard "
            "collective(s) unpaired; the scattered result stays "
            "sharded while the program's consumers expect replicated "
            "values",
            hint="pair every reduce-scatter with an all_gather on the "
                 "same axis (the ZeRO apply shape: scatter grads, "
                 "update shards, gather params), or allowlist C6 if "
                 "the program deliberately keeps that state sharded",
            source=site.source))
    return out


#: C7's tail window: the check fires only when EVERY scatter-family
#: collective issues after this fraction of the program's flops is
#: already behind it — i.e. nothing is left to overlap with.
_C7_TAIL_FRACTION = 0.10


def _segments(profile):
    """The profile cut at its program boundaries."""
    seg = []
    for ev in profile:
        if ev[0] == "cut":
            if seg:
                yield seg
            seg = []
        else:
            seg.append(ev)
    if seg:
        yield seg


def check_collective_interleaving(ex, ctx):
    """C7: scatter-family collectives bunched after the compute tail.

    Per program segment (``extract.PROGRAM_BOUNDARIES`` cuts the split
    step where JAX's programs are cut): fires when the segment (a) does
    real arithmetic, (b) issues two or more scatters, and (c) EVERY one
    of them issues after at least ``1 - _C7_TAIL_FRACTION`` of its flop
    mass. Quiet on the fused ZeRO step (each bucket's reduce-scatter
    starts from the backward), on the unfused apply (its first scatter
    leads its program) and on pure-wire programs (no flop mass)."""
    out = []
    for profile in _segments(getattr(ex, "profile", ())):
        flops_total = sum(ev[1] for ev in profile if ev[0] == "flops")
        if flops_total <= 0:
            continue
        scatters = []
        flops_before = 0
        for ev in profile:
            if ev[0] == "flops":
                flops_before += ev[1]
            elif ev[1] in _SCATTER_PRIMS:
                scatters.append((flops_before, ev))
        if len(scatters) < 2:
            continue
        threshold = (1.0 - _C7_TAIL_FRACTION) * flops_total
        if any(before < threshold for before, _ in scatters):
            continue
        first_before, (_, prim, axes, path, source) = scatters[0]
        pct = 100.0 * first_before / flops_total
        out.append(D.make(
            "C7", path,
            f"{len(scatters)} {prim} collective(s) over axis {list(axes)} "
            f"are bunched at the program tail: the first issues only after "
            f"{pct:.0f}% of the flops, so no remaining compute can hide "
            "their wire time — the reduce-scatters serialize onto the "
            "critical path",
            hint="start each bucket's reduce-scatter as its gradients "
                 "become ready (parallel.fusion.value_and_grad_bucketed "
                 "does it from autograd hooks; HOROVOD_JIT_FUSION=0 "
                 "deliberately restores the bunched split step)",
            source=source))
    return out


def check_rank_dependent_trip_count(ex, ctx):
    """C8: ranks issue the same collectives a different number of times.

    C1 catches sequences that differ in WHAT is issued; a loop whose
    trip count derives from the rank differs only in HOW OFTEN: rank A
    runs the body k times, rank B k+1 times, so B's last collective
    rendezvouses with nothing and every rank deadlocks. Folding every
    repeated block of the two sequences makes them equal."""
    out = []
    for ranks, by_rank in sorted(_group_sequences(ex).items()):
        members = sorted(by_rank)
        base = members[0]
        for other in members[1:]:
            a, b = by_rank[base], by_rank[other]
            ka, kb = [c.key for c in a], [c.key for c in b]
            if ka == kb or _collapse(ka) != _collapse(kb):
                continue
            i = _first_mismatch(a, b)
            site = a[i] if i < len(a) else b[i]
            prims = sorted({c.prim for c in a + b})
            out.append(D.make(
                "C8", site.path,
                f"collective(s) ({', '.join(prims)}) on the group of ranks "
                f"{list(ranks)} repeat a rank-dependent number of times — "
                f"rank {base} issues {len(a)}, rank {other} {len(b)}; "
                f"{_origin(ex)}: the extra iterations' "
                "collectives rendezvous with nothing: guaranteed deadlock",
                hint="make the trip count rank-invariant (all-reduce MAX "
                     "the bound before the loop), or hoist the collective "
                     "out of the loop and mask per-iteration "
                     "contributions",
                source=site.source))
            break
    return out


ALL_CHECKS = (
    check_collective_divergence,
    check_axis_validity,
    check_width_waste,
    check_schedule_conformance,
    check_shard_collective_pairing,
    check_collective_interleaving,
    check_rank_dependent_trip_count,
)


def _one_per_site(diags):
    """C1 and C8 compare every pair of ranks on every group: one finding
    a site (the same line diverging on two groups is one bug)."""
    seen, out = set(), []
    for d in diags:
        key = (d.id, d.path, d.source)
        if d.id in ("C1", "C8") and key in seen:
            continue
        seen.add(key)
        out.append(d)
    return out


def run_all(extraction, context=None):
    """Apply every check; returns the concatenated diagnostics."""
    context = context or {}
    out = []
    for check in ALL_CHECKS:
        out.extend(check(extraction, context))
    return _one_per_site(out)
