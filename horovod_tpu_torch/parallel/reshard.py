"""Resharding: the minimal collective sequence between row layouts.

The port's own copy of ``horovod_tpu/parallel/reshard.py``, the planner
of "Memory-efficient array redistribution through portable collective
communication" (arXiv:2112.01075) over the row partitions the runtime
ships: an array is REPLICATED (every rank holds all of it), SHARDED
(rank r owns a contiguous, ordered row range of axis 0) or PARTIAL
(every rank holds an unreduced addend). Between two such layouts there
is a minimal collective sequence:

========== =============== =============================================
src        dst             plan
========== =============== =============================================
X          X (same rows)   [] (zero-copy)
replicated sharded         slice (no wire)
sharded    replicated      allgatherv
sharded    sharded         alltoallv (intersection rows to new owners)
partial    replicated      allreduce
partial    sharded (even)  reducescatter
partial    sharded (other) reducescatter + alltoallv
========== =============== =============================================

Each step carries its per-rank wire-byte prediction from the ring
segment-rotation helpers of the reference's core (``ring_owned_segment``
twins). The planner half (:class:`Layout`, :func:`plan_redistribute`,
:func:`simulate_plan` and the byte helpers) is numpy only and copied, so
a plan here equals the JAX package's on the same inputs, byte for byte.

The executors run over the port's lane (``torch/mpi_ops.py``: NCCL for
CUDA tensors, gloo for CPU ones), keeping each tensor's device and
dtype:

- :func:`execute_plan`: this rank's side of a plan, each collective
  named ``{name}.{i}.{op}`` as the reference names them;
- :func:`reshard_rows`: a row-sharded array re-balanced onto the even
  layout of the current world (the elastic state flow, ZeRO's carry
  across a re-formation: ``torch/elastic.py``);
- :func:`redistribute`: this rank's block moved between two (mesh,
  spec) layouts of ``parallel.mesh``/``parallel.sharding``, zero-copy
  when they agree (``hvd.redistribute``).

NCCL and gloo report no transport bytes for alltoall and allgather, so
the port holds a plan to the JAX package's ``plan_redistribute`` where
the reference reconciles measured wire bytes (ROADMAP.md's deliberate
differences).
"""

import dataclasses
import math

import numpy as np

__all__ = [
    "Layout",
    "ReshardPlan",
    "ReshardStep",
    "plan_redistribute",
    "simulate_plan",
    "execute_plan",
    "reshard_rows",
    "redistribute",
    "layout_from_spec",
    "alltoallv_splits",
    "even_row_layout",
    "hier_wire_bytes",
    "flat_allreduce_wire_bytes",
]


def _ring_send_segment(rank, step, size, rot=0):
    """Python twin of ``csrc/ring_ops.h RingSendSegment`` (pinned
    against the C ABI in tests/single/test_reshard.py)."""
    return ((rank - step + rot) % size + 2 * size) % size


def _even_split(n_rows, n_shards):
    """The ONE row-split rule, shared with the core (q + remainder to
    lower ranks — csrc/operations.cc REDUCESCATTER and ring
    segmentation use the same arithmetic)."""
    q, r = divmod(n_rows, n_shards)
    return tuple(q + (1 if i < r else 0) for i in range(n_shards))


# ---- layouts ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Layout:
    """How one logical array is distributed over ``nranks`` ranks.

    ``kind``: ``"replicated"`` | ``"sharded"`` | ``"partial"``.
    ``rows``: for sharded, the per-rank ``(start, n)`` row ranges —
    required to be an ordered contiguous partition of ``[0, n_rows)``
    (rank r's rows all precede rank r+1's), which is what makes the
    sharded->sharded alltoallv receive rows already in order.
    """

    kind: str
    nranks: int
    rows: tuple = ()

    def __post_init__(self):
        if self.kind not in ("replicated", "sharded", "partial"):
            raise ValueError(f"unknown layout kind {self.kind!r}")
        if self.kind == "sharded":
            if len(self.rows) != self.nranks:
                raise ValueError(
                    f"sharded layout needs one (start, n) per rank: got "
                    f"{len(self.rows)} for {self.nranks} ranks")
            pos = 0
            for start, n in self.rows:
                if start != pos or n < 0:
                    raise ValueError(
                        f"rows {self.rows} are not an ordered contiguous "
                        f"partition (rank range starting at {start}, "
                        f"expected {pos})")
                pos += n
        elif self.rows:
            raise ValueError(f"{self.kind} layout carries no rows")

    @property
    def n_rows(self):
        return sum(n for _, n in self.rows)

    def range_of(self, rank):
        return self.rows[rank]

    @staticmethod
    def replicated(nranks):
        return Layout("replicated", nranks)

    @staticmethod
    def partial(nranks):
        return Layout("partial", nranks)

    @staticmethod
    def sharded(n_rows, nranks):
        """Even split, remainder to lower ranks — the core's rule."""
        starts, pos = [], 0
        for n in _even_split(n_rows, nranks):
            starts.append((pos, n))
            pos += n
        return Layout("sharded", nranks, tuple(starts))

    @staticmethod
    def from_rows(rows):
        return Layout("sharded", len(rows), tuple(tuple(r) for r in rows))


def even_row_layout(n_rows, n_shards):
    """Alias for :meth:`Layout.sharded` (the checkpoint-resharding
    entry point reads better with a verb-free name)."""
    return Layout.sharded(n_rows, n_shards)


# ---- plan ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ReshardStep:
    """One collective of a plan. ``op`` in {slice, allgatherv,
    alltoallv, reducescatter, allreduce}; ``wire_tx``/``wire_rx`` are
    per-rank transport-byte predictions matching the core's WireTally
    accounting exactly (csrc/ring_ops.cc)."""

    op: str
    wire_tx: tuple
    wire_rx: tuple
    detail: str = ""


@dataclasses.dataclass(frozen=True)
class ReshardPlan:
    src: Layout
    dst: Layout
    shape: tuple
    itemsize: int
    steps: tuple

    @property
    def zero_copy(self):
        return not self.steps

    def wire_tx_bytes(self, rank=None):
        """Predicted transport tx bytes (this rank, or total)."""
        if rank is None:
            return sum(sum(s.wire_tx) for s in self.steps)
        return sum(s.wire_tx[rank] for s in self.steps)

    def wire_rx_bytes(self, rank=None):
        if rank is None:
            return sum(sum(s.wire_rx) for s in self.steps)
        return sum(s.wire_rx[rank] for s in self.steps)

    def expected_collectives(self, axis="shard"):
        """The collective signature this plan corresponds to, in hvdlint
        C5's ``expect_collectives`` shape and in the primitive names the
        recorder emits (``analysis/extract.py``: an allgatherv is an
        ``all_gather``, an alltoallv an ``all_to_all``, a reduce-scatter
        a ``psum_scatter``, an allreduce a ``psum``): the bridge between
        a plan and the registered ``redistribute_to_replicated``."""
        prims = {"allgatherv": "all_gather", "alltoallv": "all_to_all",
                 "reducescatter": "psum_scatter", "allreduce": "psum"}
        return [(prims[s.op], (axis,)) for s in self.steps
                if s.op in prims]

    def describe(self):
        if not self.steps:
            return "zero-copy (layouts agree)"
        return " -> ".join(
            f"{s.op}[{s.detail}]" if s.detail else s.op
            for s in self.steps)


def _row_bytes(shape, itemsize):
    return int(math.prod(shape[1:])) * itemsize if len(shape) > 1 \
        else itemsize


def _allgatherv_step(layout, shape, itemsize):
    """Ring allgatherv of per-rank row blocks: at step s rank r sends
    block (r - s) mod N and receives block (r - s - 1) mod N
    (csrc/ring_ops.cc Allgatherv)."""
    n = layout.nranks
    rb = _row_bytes(shape, itemsize)
    blk = [rows * rb for _, rows in layout.rows]
    tx = [sum(blk[(r - s + n) % n] for s in range(n - 1)) for r in range(n)]
    rx = [sum(blk[(r - s - 1 + n) % n] for s in range(n - 1))
          for r in range(n)]
    return ReshardStep("allgatherv", tuple(tx), tuple(rx),
                       detail=f"{n} blocks")


def _alltoallv_step(src, dst, shape, itemsize):
    """Pairwise exchange of intersection row ranges. Includes the
    8-byte-per-rank recv-splits exchange the eager ALLTOALL response
    performs before the payload (csrc/operations.cc)."""
    n = src.nranks
    rb = _row_bytes(shape, itemsize)
    send = [[0] * n for _ in range(n)]
    for r in range(n):
        s0, sn = src.range_of(r)
        for d in range(n):
            d0, dn = dst.range_of(d)
            lo, hi = max(s0, d0), min(s0 + sn, d0 + dn)
            if hi > lo:
                send[r][d] = (hi - lo) * rb
    # Splits exchange: Alltoallv of one int64 per rank (self skipped on
    # the wire), then the payload exchange (self handled by memcpy).
    tx = [8 * (n - 1) + sum(b for d, b in enumerate(send[r]) if d != r)
          for r in range(n)]
    rx = [8 * (n - 1) + sum(send[s][r] for s in range(n) if s != r)
          for r in range(n)]
    return ReshardStep("alltoallv", tuple(tx), tuple(rx),
                       detail="intersection rows")


def _ring_reduce_phase_bytes(counts, size, rot, rank):
    """tx elems of one N-1-step ring reduce phase at rotation ``rot``
    for ``rank`` (csrc PipelinedReduceChunks tally)."""
    return sum(counts[_ring_send_segment(rank, s, size, rot)]
               for s in range(size - 1))


def _reducescatter_step(layout, shape, itemsize, compressed=False):
    """Ring reduce-scatter at rot=-1 over the EVEN split (the core's
    REDUCESCATTER row rule). Wire halves when the f32 payload rides the
    bf16 codec."""
    n = layout.nranks
    rb = _row_bytes(shape, itemsize)
    counts = [rows * rb for rows in _even_split(shape[0], n)]
    scale = 0.5 if compressed else 1.0
    tx, rx = [], []
    for r in range(n):
        t = _ring_reduce_phase_bytes(counts, n, -1, r)
        v = sum(counts[_ring_send_segment(r, s + 1, n, -1)]
                for s in range(n - 1))
        tx.append(int(t * scale))
        rx.append(int(v * scale))
    return ReshardStep("reducescatter", tuple(tx), tuple(rx),
                       detail="even split")


def _allreduce_step(shape, itemsize, nranks, compressed=False):
    """Flat ring allreduce: reduce-scatter phase (rot=0) + allgather
    phase (send rot=1 / recv rot=0 segments)."""
    total = int(math.prod(shape)) if shape else 1
    counts = [c * itemsize for c in _even_split(total, nranks)]
    scale = 0.5 if compressed else 1.0
    tx, rx = [], []
    for r in range(nranks):
        t = _ring_reduce_phase_bytes(counts, nranks, 0, r)
        t += sum(counts[_ring_send_segment(r, s, nranks, 1)]
                 for s in range(nranks - 1))
        v = sum(counts[_ring_send_segment(r, s + 1, nranks, 0)]
                for s in range(nranks - 1))
        v += sum(counts[_ring_send_segment(r, s, nranks, 0)]
                 for s in range(nranks - 1))
        tx.append(int(t * scale))
        rx.append(int(v * scale))
    return ReshardStep("allreduce", tuple(tx), tuple(rx))


def flat_allreduce_wire_bytes(count, itemsize, size, rank,
                              compressed=False):
    """Per-rank transport tx bytes of one flat ring allreduce — the
    telemetry-predictor twin of the core's WireTally (docs/wire.md)."""
    step = _allreduce_step((count,), itemsize, size,
                           compressed=compressed)
    return step.wire_tx[rank]


def hier_wire_bytes(count, itemsize, size, local_size, rank,
                    compress_cross=False, compressed=False):
    """Per-rank wire tx bytes of the hierarchical cross-plane allreduce,
    split by plane: ``{"intra": ..., "cross": ...}``.

    Mirrors csrc/ring_ops.cc HierarchicalAllreduce exactly: intra-slice
    reduce-scatter (rot=-1) over ``local_size`` group members, flat
    allreduce of this rank's 1/local_size segment among the
    ``size/local_size`` same-local-rank peers (the CROSS plane —
    compressed when either knob engages the bf16 codec there), then the
    intra-slice ring allgatherv of the finalized segments.
    """
    L, M = local_size, size // local_size
    lr = rank % L
    seg = _even_split(count, L)
    seg_bytes = [c * itemsize for c in seg]
    intra_scale = 0.5 if compressed and itemsize == 4 else 1.0
    cross_scale = 0.5 if (compressed or compress_cross) and itemsize == 4 \
        else 1.0
    # Phase 1: local reduce-scatter at rot=-1.
    intra = _ring_reduce_phase_bytes(seg_bytes, L, -1, lr) * intra_scale
    # Phase 3: local allgatherv of the segment blocks (never compressed
    # — only reduce phases ride the codec).
    intra += sum(seg_bytes[(lr - s + L) % L] for s in range(L - 1))
    # Phase 2: flat allreduce of segment lr across M slices.
    my = seg[lr]
    cross_counts = [c * itemsize for c in _even_split(my, M)]
    cr = rank // L
    cross = _ring_reduce_phase_bytes(cross_counts, M, 0, cr)
    cross += sum(cross_counts[_ring_send_segment(cr, s, M, 1)]
                 for s in range(M - 1))
    return {"intra": int(intra), "cross": int(cross * cross_scale)}


def plan_redistribute(shape, dtype, src, dst, compressed=False):
    """Plan the minimal collective sequence moving a ``shape``/``dtype``
    array from layout ``src`` to layout ``dst`` (the table in the
    module docstring). Raises on rank-count mismatch or sharded layouts
    that do not cover the array's rows.

    ``compressed`` mirrors the runtime's ``HOROVOD_WIRE_COMPRESSION``
    knob: the reduce phases of the plan's allreduce/reduce-scatter
    steps then ride the bf16 codec (f32 payloads only), halving their
    predicted wire bytes — callers executing under the compressed wire
    must pass it or the byte reconciliation reads 2x. Gather/exchange
    steps never compress (the codec covers reduce phases only)."""
    if src.nranks != dst.nranks:
        raise ValueError(
            f"src ({src.nranks} ranks) and dst ({dst.nranks} ranks) must "
            "describe the same world — resizing the WORLD is the elastic "
            "layer's job; resharding redistributes within one world")
    shape = tuple(int(d) for d in shape)
    itemsize = np.dtype(dtype).itemsize
    for layout, name in ((src, "src"), (dst, "dst")):
        if layout.kind == "sharded" and layout.n_rows != shape[0]:
            raise ValueError(
                f"{name} layout covers {layout.n_rows} rows; array has "
                f"{shape[0]}")
    if dst.kind == "partial":
        raise ValueError("a partial (pending-reduction) destination is "
                         "not a materializable layout")
    n = src.nranks
    zeros = tuple(0 for _ in range(n))
    # The bf16 codec engages on f32 reduce phases only (docs/wire.md).
    comp = bool(compressed) and itemsize == 4

    def slice_step():
        return ReshardStep("slice", zeros, zeros, detail="local rows")

    steps = []
    if src == dst:
        pass  # zero-copy
    elif src.kind == "replicated":
        # dst sharded: every rank already holds its rows.
        steps.append(slice_step())
    elif src.kind == "sharded":
        if dst.kind == "replicated":
            steps.append(_allgatherv_step(src, shape, itemsize))
        else:  # sharded -> sharded, different rows
            steps.append(_alltoallv_step(src, dst, shape, itemsize))
    else:  # partial source
        if dst.kind == "replicated":
            steps.append(_allreduce_step(shape, itemsize, n,
                                         compressed=comp))
        else:
            even = Layout.sharded(shape[0], n)
            steps.append(_reducescatter_step(even, shape, itemsize,
                                             compressed=comp))
            if dst != even:
                steps.append(_alltoallv_step(even, dst, shape, itemsize))
    return ReshardPlan(src=src, dst=dst, shape=shape, itemsize=itemsize,
                       steps=tuple(steps))


# ---- executors -------------------------------------------------------

def simulate_plan(plan, locals_by_rank):
    """Pure-numpy all-rank reference executor (the property-test
    oracle): ``locals_by_rank[r]`` is rank r's local block under
    ``plan.src``; returns the per-rank blocks under ``plan.dst``.
    No wire, but the SAME data movement semantics as execute_plan."""
    n = plan.src.nranks
    src, dst = plan.src, plan.dst
    if src.kind == "replicated":
        full = locals_by_rank[0]
    elif src.kind == "sharded":
        full = np.concatenate([np.asarray(b) for b in locals_by_rank])
    else:  # partial: the logical value is the sum of addends
        full = np.sum([np.asarray(b) for b in locals_by_rank], axis=0)
    if dst.kind == "replicated":
        return [full.copy() for _ in range(n)]
    return [full[s:s + c].copy() for s, c in dst.rows]


def alltoallv_splits(plan, step, rank, n_local):
    """The rows rank ``rank`` sends to each destination in step ``step``
    (an ``alltoallv``) of ``plan``, from its ``n_local``-row block: the
    intersection of its source rows with each destination's. Contiguous
    ordered partitions on both sides make them consecutive runs of the
    block, arriving already in the destination's order. A later step's
    source is the even layout the reduce-scatter before it left."""
    src = plan.src if step == 0 else \
        Layout.sharded(plan.shape[0], plan.src.nranks)
    s0, _ = src.range_of(rank)
    splits = []
    for d in range(plan.dst.nranks):
        d0, dn = plan.dst.range_of(d)
        lo, hi = max(s0, d0), min(s0 + n_local, d0 + dn)
        splits.append(max(hi - lo, 0))
    return splits


def _lane():
    from horovod_tpu_torch.torch import mpi_ops

    return mpi_ops


def _rank():
    from horovod_tpu_torch.common import basics

    return basics.rank()


def execute_plan(plan, local, name="reshard", ops=None):
    """Run this rank's side of ``plan`` over the lane; returns the local
    block under ``plan.dst``, on ``local``'s device and in its dtype.

    ``local`` is this rank's block under ``plan.src`` (the full tensor
    for a replicated or partial source). Collective: every rank calls
    with the same ``name`` in the same order. ``ops`` (default the lane,
    ``torch/mpi_ops.py``) is injectable for tests. A zero-copy plan
    returns ``local`` itself."""
    if plan.zero_copy:
        return local
    ops = ops or _lane()
    rank = _rank()
    out = local.contiguous()
    for i, step in enumerate(plan.steps):
        sname = f"{name}.{i}.{step.op}"
        if step.op == "slice":
            s, c = plan.dst.range_of(rank)
            out = out[s:s + c].clone()
        elif step.op == "allgatherv":
            out = ops.allgather(out, name=sname)
        elif step.op == "alltoallv":
            out = ops.alltoall(out, alltoallv_splits(plan, i, rank,
                                                     out.shape[0]),
                               name=sname)
        elif step.op == "reducescatter":
            out = ops.reducescatter(out, name=sname, op=ops.Sum)
        elif step.op == "allreduce":
            out = ops.allreduce(out, name=sname, op=ops.Sum)
        else:  # pragma: no cover: the planner emits only the ops above
            raise ValueError(f"unknown plan step {step.op!r}")
    return out


def rows_layout(rows_held):
    """The sharded :class:`Layout` in which rank r holds the next
    ``rows_held[r]`` rows."""
    rows, pos = [], 0
    for c in rows_held:
        rows.append((pos, int(c)))
        pos += int(c)
    return Layout.from_rows(rows)


def reshard_rows(local, rows_held, name="elastic.reshard", ops=None):
    """Re-balance a row-sharded tensor onto the even layout of the
    current world (the elastic state flow).

    After a re-formation every member passes the rows each rank of the
    NEW world holds (``rows_held``, by rank; a joiner holds 0) and its
    own block ``local`` (a joiner: a ``(0, ...)`` tensor of the right
    trailing shape, dtype and device). Returns this rank's block under
    the even partition (:meth:`Layout.sharded`), moved by one alltoallv.
    Collective: every rank calls with identical ``rows_held`` and
    ``name``; derive ``rows_held`` from synced state (the committed
    layout mapped through the survivor list), never from what one rank
    observes."""
    src = rows_layout(rows_held)
    if src.range_of(_rank())[1] != local.shape[0]:
        raise ValueError(
            f"rows_held says rank {_rank()} holds "
            f"{src.range_of(_rank())[1]} rows; its block has "
            f"{local.shape[0]}")
    dst = Layout.sharded(src.n_rows, src.nranks)
    plan = plan_redistribute((src.n_rows,) + tuple(local.shape[1:]),
                             torch_dtype_as_numpy(local.dtype), src, dst)
    return execute_plan(plan, local, name=name, ops=ops)


def torch_dtype_as_numpy(dtype):
    """A numpy dtype of a torch ``dtype``'s width, for the planner, which
    reads only the itemsize (bf16 has no numpy dtype)."""
    return np.dtype(f"V{dtype.itemsize}")


# ---- the mesh surface -------------------------------------------------

def _row_blocks(mesh, spec):
    """Every rank's block index along axis 0 under ``spec`` (None when
    the spec replicates axis 0) and the block count."""
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER

    spec = tuple(spec)
    if any(e is not None for e in spec[1:]):
        raise ValueError(
            f"redistribute plans axis-0 row layouts; spec {spec} shards "
            "a later axis (transpose it to axis 0 first)")
    axis0 = spec[0] if spec else None
    if axis0 is None:
        return [None] * mesh.size, 1
    if getattr(axis0, "virtual", 1) > 1:
        raise ValueError(f"spec {spec}: an interleaved axis 0 is not a "
                         "row layout of contiguous blocks")
    names = (axis0,) if isinstance(axis0, str) else tuple(axis0)
    grid = tuple(mesh.shape[a] for a in AXIS_ORDER)
    blocks = []
    for r in range(mesh.size):
        coords = dict(zip(AXIS_ORDER, np.unravel_index(r, grid)))
        i = 0
        for a in names:
            i = i * mesh.shape[a] + int(coords[a])
        blocks.append(i)
    return blocks, math.prod(mesh.shape[a] for a in names)


def layout_from_spec(mesh, spec, shape):
    """The row :class:`Layout` of ``spec`` (a ``parallel.sharding.P``
    whose axis 0 is its only split dim) over ``mesh``: replicated over
    every rank, or the even split into as many blocks as the axes named
    by axis 0 make (ranks along the other axes hold replicas, which do
    not change which rows exist). The counterpart of the reference's
    ``layout_from_sharding``."""
    blocks, count = _row_blocks(mesh, spec)
    if blocks[0] is None:
        return Layout.replicated(mesh.size)
    return Layout.sharded(int(shape[0]), count)


def _rank_rows(mesh, spec, n_rows):
    """Each rank's ``(start, n)`` rows under ``spec`` and whether it is
    its block's first holder (a replicated spec: every rank holds every
    row and is a holder)."""
    blocks, count = _row_blocks(mesh, spec)
    if blocks[0] is None:
        return [((0, n_rows), True)] * mesh.size
    even = Layout.sharded(n_rows, count)
    seen, out = set(), []
    for b in blocks:
        out.append((even.range_of(b), b not in seen))
        seen.add(b)
    return out


def redistribute(local, src, dst, name="redistribute", ops=None):
    """``hvd.redistribute(local, (mesh, spec), (mesh, spec))``: this
    rank's block under ``src`` moved to its block under ``dst``.

    Zero-copy when the layouts agree (the same mesh object and equal
    specs): the same tensor comes back. A replicated source slices each
    rank's rows with no wire. Otherwise one alltoallv: each block's
    first holder (the lowest rank holding it) sends every rank the rows
    of its block that rank's destination block needs, and a rank joins
    what it received in row order. Between layouts with one block a
    rank in rank order this is the planner's alltoallv (allgatherv to a
    replicated destination); ranks that hold replicas receive their
    rows too. Collective over the mesh's world."""
    (smesh, sspec), (dmesh, dspec) = src, dst
    if smesh is dmesh and tuple(sspec) == tuple(dspec):
        return local
    if smesh.size != dmesh.size:
        raise ValueError(
            f"src ({smesh.size} ranks) and dst ({dmesh.size} ranks) must "
            "span the same world: resizing the world is the elastic "
            "layer's job")
    s_blocks, s_count = _row_blocks(smesh, sspec)
    n_rows = local.shape[0] * (1 if s_blocks[0] is None else s_count)
    s_rows = _rank_rows(smesh, sspec, n_rows)
    d_rows = [r for r, _ in _rank_rows(dmesh, dspec, n_rows)]
    me = smesh.rank
    if s_blocks[0] is None:
        d0, dn = d_rows[me]
        return local[d0:d0 + dn].clone()
    n = smesh.size

    def piece(r, d):
        (s0, sn), first = s_rows[r]
        d0, dn = d_rows[d]
        lo, hi = max(s0, d0), min(s0 + sn, d0 + dn)
        return (lo, hi) if first and hi > lo else (lo, lo)

    (s0, _), _ = s_rows[me]
    sends = [piece(me, d) for d in range(n)]
    buf = _cat([local[lo - s0:hi - s0] for lo, hi in sends], local)
    ops = ops or _lane()
    got = ops.alltoall(buf, [hi - lo for lo, hi in sends], name=name)
    parts, off = [], 0
    for r in range(n):
        lo, hi = piece(r, me)
        parts.append((lo, got[off:off + hi - lo]))
        off += hi - lo
    parts.sort(key=lambda p: p[0])
    return _cat([t for _, t in parts], local)


def _cat(tensors, like):
    """``tensors`` joined along dim 0 (an empty block of ``like``'s
    trailing shape when there are none)."""
    import torch

    tensors = [t for t in tensors if t.shape[0]]
    if not tensors:
        return like.new_empty((0,) + tuple(like.shape[1:]))
    return torch.cat(tensors) if len(tensors) > 1 else tensors[0].clone()
