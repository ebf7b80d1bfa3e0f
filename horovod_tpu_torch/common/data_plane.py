"""Run one negotiated response on ``torch.distributed``: NCCL for CUDA
tensors, gloo for CPU tensors.

Counterpart of the reference's two data planes: the device plane
``horovod_tpu/jax/xla_ici.py`` (``_reduce:497``,
``_build_allreduce_local:514``, ``_build_allreduce:536``,
``_build_broadcast:586``, ``_build_allgather:600``,
``_build_alltoall:609``, ``_build_reducescatter:622``) and the host lane
of ``csrc/operations.cc`` (``ExecuteAllreduce``, ``ExecuteEntry``) and
``csrc/ring_ops.cc``, whose arithmetic the port follows where the two
differ, since the reference frontend's CPU tensors run on it:

- Scaling is the host lane's ``ScaleBuffer``: ``x * factor`` in f64,
  rounded to f32 first for f16/bf16, integers truncated toward zero;
  int8, uint8 and bool are never scaled (so their Average is a Sum).
  Average is Sum followed by one scale of ``postscale / size``.
- A lone bf16 allreduce with a prescale and a linear op (Sum, Average)
  folds the prescale into that post scale, as ``ExecuteAllreduce`` does;
  a fused response prescales each tensor in the buffer.
- Product gathers every contribution and multiplies (``xla_ici.py:508``);
  bool Sum/Product are Or/And (Max/Min on bytes).
- Allgather pads each contribution to the largest first dim, gathers
  and slices (``:600``); reducescatter is one reduce-scatter of the
  rows (uneven segments padded to the largest), the first dim split as
  evenly as possible with the remainder to the lower positions
  (``:622``), as the host lane's ``ReduceScatterv`` moves (N-1)/N of the
  tensor (Product reduces the whole tensor on its gather path and keeps
  this member's rows); alltoall sends each member's negotiated splits of
  rows.
- A set of one still makes its collective call (Adasum, with no
  partner, a one-rank sum), so that the card path is the real one.
- Hierarchical allreduce (``HOROVOD_CROSS_PLANE``, ``csrc/ring_ops.cc:797
  HierarchicalAllreduce``): with a split ``L > 1`` (:attr:`hier_split`)
  the global set's allreduce is a reduce-scatter over this rank's slice
  of ``L`` consecutive ranks (segments of ``q + 1`` elements to the first
  ``count % L`` of them), an allreduce of its segment over the ranks of
  the same local rank on every slice, the postscale applied there once,
  and an allgather over the slice. A world that ``L`` does not tile into
  several slices, another process set, Adasum and Product run flat
  (Product: its gather path, ROADMAP.md queue C).
- Wire compression (``HOROVOD_WIRE_COMPRESSION``, ``csrc/ring_ops.cc:1285``
  and ``:1495``): an f32 Sum or Average allreduce or reducescatter over
  two or more ranks narrows its wire to bf16 or int8
  (``ops/wire_codec.py``, the codec kernels on the card) and sums in f32.
  Each rank encodes every destination segment and one ``all_to_all``
  exchanges the images; the segment's owner decodes the contributions
  and adds them in rank order; for an allreduce it encodes the finished
  segment once, and after an ``all_gather`` of the images every rank, the
  owner too, decodes the same bits with the postscale folded in. Under
  ``HOROVOD_CROSS_PLANE_COMPRESSION`` the hierarchical allreduce's cross
  hop alone takes bf16. Everything else takes the exact path.

Allreduces of a response share a fusion buffer, one per device and
dtype, allocated once at the threshold and reused; an atomic group
larger than the threshold gets its own. A lone tensor is reduced in
place in its output. When the autotuner moves the threshold
(:meth:`DataPlane.set_fusion_threshold`, on the lane thread between two
cycles' responses, never under a live one) the buffers are dropped and
the next response allocates them at the new size.

Each response records, per tensor, its timeline activities (the
fusion-buffer copies and the collective, named for its transport:
``NCCL_ALLREDUCE``, ``GLOO_BCAST``...), each collective call's time in
the metrics' ``wire_us`` (host time on gloo; on NCCL two CUDA events on
the lane's stream, read once completed) and each fused response's fill.

The ``wire`` bytes of the metrics are booked per allreduce and
reducescatter from the segment math (NCCL and gloo report none): an exact
collective books the reference ring's bytes (a reducescatter the ring's
reduce phase at rotation -1), a compressed one the images its
``all_to_all`` and ``all_gather`` send (the padding of uneven segments to
the largest not counted, as in the exact path's padded calls); the
hierarchical allreduce's cross hop books under ``cross_*`` too. Adasum
and Product book none.

CUDA ordering: everything runs on the lane's own stream, which first
waits on the event each tensor's producer stream recorded at enqueue;
inputs and outputs are ``record_stream``-ed to it, and the caller's
stream waits on the returned completion event before it reads a result.
"""

import collections
import contextlib

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import adasum
from horovod_tpu_torch.common.message import ReduceOp, ResponseType
from horovod_tpu_torch.common.metrics import REGISTRY, now_us
from horovod_tpu_torch.ops import wire_codec
from horovod_tpu_torch.ops.wire_codec import Segments, image_len

_SCALED = (torch.float16, torch.bfloat16, torch.float32, torch.float64,
           torch.int32, torch.int64)
_CHUNK = 1 << 24     # elements scaled at a time: bounds the f64 temporary
_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM,
             ReduceOp.AVERAGE: dist.ReduceOp.SUM,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.MAX: dist.ReduceOp.MAX}
# bool rides as bytes: Sum is Or, Product And.
_BOOL_OP = {ReduceOp.SUM: dist.ReduceOp.MAX,
            ReduceOp.AVERAGE: dist.ReduceOp.MAX,
            ReduceOp.MIN: dist.ReduceOp.MIN,
            ReduceOp.MAX: dist.ReduceOp.MAX,
            ReduceOp.PRODUCT: dist.ReduceOp.MIN}
_all_gather_flat = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor
# The collective's timeline activity, after the transport's prefix.
_ACTIVITY = {ResponseType.ALLREDUCE: "ALLREDUCE",
             ResponseType.ALLGATHER: "ALLGATHER",
             ResponseType.BROADCAST: "BCAST",
             ResponseType.ALLTOALL: "ALLTOALL",
             ResponseType.REDUCESCATTER: "REDUCESCATTER"}


class ResponseError(ValueError):
    """A response every rank refuses alike, before any traffic (the
    handles fail; the lane goes on)."""


def scale_(t, factor):
    """In place: the host lane's ``ScaleBuffer(t, factor)``."""
    if factor == 1.0 or t.dtype not in _SCALED:
        return t
    flat = t.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        part = flat[i:i + _CHUNK]
        x = part.double() * factor
        if part.dtype in (torch.float16, torch.bfloat16):
            x = x.float()
        elif not part.dtype.is_floating_point:
            x = x.trunc()
        part.copy_(x)
    return t


def ring_allreduce_bytes(counts, r):
    """(tx, rx) bytes of rank ``r`` in the reference's ring allreduce of
    segments of ``counts`` bytes (``csrc/ring_ops.h RingSendSegment``):
    each phase sends all segments but one and receives all but one."""
    n, total = len(counts), sum(counts)
    return (2 * total - counts[(r + 1) % n] - counts[(r + 2) % n],
            2 * total - counts[r] - counts[(r + 1) % n])


def ring_reducescatter_bytes(counts, r):
    """(tx, rx) of the ring's reduce phase at rotation -1 (after it rank
    r holds segment r)."""
    total = sum(counts)
    return total - counts[r], total - counts[(r - 1) % len(counts)]


def ring_allgather_bytes(counts, r):
    """(tx, rx) of the ring allgather of one segment a rank."""
    total = sum(counts)
    return total - counts[(r + 1) % len(counts)], total - counts[r]


def exchange_bytes(counts, r):
    """(tx, rx) of the compressed path's ``all_to_all``: each rank sends
    segment j's image to rank j and receives one image of its own from
    each peer. Its ``all_gather`` of the finished images moves the
    reverse: (rx, tx)."""
    n = len(counts)
    return sum(counts) - counts[r], (n - 1) * counts[r]


def _post_factor(op, postscale, n):
    return postscale / n if op == ReduceOp.AVERAGE else postscale


def _wire(t):
    """bool tensors travel as bytes."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


class DataPlane:
    """Executes responses for one rank. ``device`` is the card of this
    rank (``cuda:{local_rank}``) or None for a CPU-only lane.
    ``launches`` counts the collectives issued, by backend; ``by_op`` by
    (backend, collective); ``bytes_moved`` the bytes the lane's copies,
    scales and collectives read and write (a collective in place on one
    buffer reads and writes it, except in a set of one). ``timeline`` is
    the lane's :class:`~timeline.Timeline`, set by its runtime."""

    def __init__(self, device, fusion_threshold, world=1):
        self.device = device
        self.fusion_threshold = fusion_threshold
        self.world = world
        # The lane's wire knobs (basics.py sets them at init, the
        # autotuner moves the codec and the split in lockstep):
        # ``wire_codec`` 0 off, 1 bf16, 2 int8; ``cross_compression``
        # bf16 on the hierarchical allreduce's cross hop alone;
        # ``hier_split`` 0 flat, L > 1 slices of L consecutive ranks, each
        # split's (local, cross) SetGroups in ``hier_groups``.
        self.wire_codec = 0
        self.cross_compression = False
        self.hier_split = 0
        self.hier_groups = {}
        self._dev = "cpu"
        self.timeline = None
        self.stream = None
        self.launches = collections.Counter()
        self.by_op = collections.Counter()
        self.bytes_moved = 0
        # Off only in chip_smoke.py's negative control of the ordering
        # check: without the wait, a producer's late write is not seen.
        self.wait_for_producers = True
        self._buffers = {}
        # The overlap ledger's plane of the calls being made: 1 inside
        # the hierarchical allreduce's cross hop, else 0.
        self._span_plane = 0

    def start_thread(self):
        """Called on the lane thread before its first response."""
        if self.device is not None:
            torch.cuda.set_device(self.device)
            self.stream = torch.cuda.Stream(self.device)

    def zeros(self, shape, dtype, device):
        """A joined rank's zero contribution, made on the lane's stream."""
        if device != "cuda":
            return torch.zeros(shape, dtype=dtype)
        with torch.cuda.stream(self.stream):
            return torch.zeros(shape, dtype=dtype, device=self.device)

    def set_fusion_threshold(self, nbytes):
        """Adopt a new fusion threshold: the buffers are reallocated at
        it by the next response that needs them."""
        if nbytes != self.fusion_threshold:
            self.fusion_threshold = nbytes
            self._buffers.clear()

    def reset_counts(self):
        self.launches.clear()
        self.by_op.clear()
        self.bytes_moved = 0

    # ---- entry point ------------------------------------------------

    def execute(self, response, entries, pset):
        """Run ``response`` over the process set ``pset`` for this rank's
        ``entries`` (in response order; zero-filled ones for a joined
        rank). Sets each entry's ``result``; returns the CUDA completion
        event, or None."""
        if response.response_type == ResponseType.BARRIER:
            return None      # the negotiation itself was the barrier
        if response.device != "cuda":
            self._run_response(response, entries, pset, pset.groups["cpu"])
            return None
        with torch.cuda.stream(self.stream):
            for e in entries:
                if e.ready_event is not None and self.wait_for_producers:
                    self.stream.wait_event(e.ready_event)
                for t in (e.input, e.output):
                    if t is not None:
                        t.record_stream(self.stream)
            self._run_response(response, entries, pset, pset.groups["cuda"])
            done = torch.cuda.Event()
            done.record(self.stream)
        return done

    def _run_response(self, response, entries, pset, pg):
        kind = response.response_type
        if kind not in _ACTIVITY:
            raise ValueError(f"unsupported response type {kind}")
        n, pos = pset.size(), pset.position
        self._dev = response.device
        self._label = ("NCCL_" if response.device == "cuda" else "GLOO_") + \
            _ACTIVITY[kind]
        if kind == ResponseType.ALLREDUCE:
            self._allreduce(entries, response.reduce_op, pg, n, pos, pset)
            return
        e = entries[0]
        with self._activity(entries, self._label):
            if kind == ResponseType.ALLGATHER:
                self._allgather(e, response.tensor_sizes, pg, n, pos)
            elif kind == ResponseType.BROADCAST:
                self._collective(pg, "broadcast", dist.broadcast,
                                 _wire(e.output), src=response.root_rank)
                e.result = e.output
            elif kind == ResponseType.ALLTOALL:
                self._alltoall(e, response.splits, pg, pos)
            else:
                self._reducescatter(e, response.reduce_op, pg, n, pos)

    @contextlib.contextmanager
    def _activity(self, entries, label):
        """A timeline activity of each entry's tensor around the block."""
        tl = self.timeline
        if tl is None or not tl.enabled:
            yield
            return
        for e in entries:
            tl.activity_start(e.request.tensor_name, label)
        yield
        for e in entries:
            tl.activity_end(e.request.tensor_name)

    @contextlib.contextmanager
    def _wire_span(self, pg):
        """One collective call's time into the metrics' ``wire_us``, the
        overlap ledger and the ``wire_span`` events, on the plane of
        :attr:`_span_plane`."""
        if dist.get_backend(pg) != "nccl":
            t0 = now_us()
            yield
            REGISTRY.wire_span(self._span_plane, t0, now_us())
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        REGISTRY.cuda_span(start, end, self._span_plane)

    def _collective(self, pg, name, fn, *args, **kwargs):
        backend = dist.get_backend(pg)
        self.launches[backend] += 1
        self.by_op[(backend, name)] += 1
        tensors = [a for a in args if torch.is_tensor(a)]
        if len(tensors) > 1:
            self.bytes_moved += sum(t.nbytes for t in tensors)
        elif dist.get_world_size(pg) > 1:
            # In place on one rank NCCL and gloo move nothing.
            self.bytes_moved += 2 * tensors[0].nbytes
        with self._wire_span(pg):
            fn(*args, group=pg, async_op=True, **kwargs).wait()

    def _copy(self, dst, src):
        self.bytes_moved += 2 * dst.nbytes
        dst.copy_(src)

    def _scale(self, t, factor):
        if factor != 1.0 and t.dtype in _SCALED:
            self.bytes_moved += 2 * t.nbytes
            scale_(t, factor)

    # ---- reductions --------------------------------------------------

    def _reduce_(self, buf, op, pg, n, pos, pset):
        """In place on the 1-D ``buf``: the sum/min/max/product over the
        set, or Adasum. Average's division is left to the post scale."""
        if op == ReduceOp.ADASUM:
            if n == 1:
                self._collective(pg, "all_reduce", dist.all_reduce, buf,
                                 op=dist.ReduceOp.SUM)
                return
            adasum.allreduce_(buf, pos, n, *self._p2p(pg, pset))
            return
        if buf.dtype == torch.bool:
            self._collective(pg, "all_reduce", dist.all_reduce, _wire(buf),
                             op=_BOOL_OP[op])
        elif op == ReduceOp.PRODUCT:
            gathered = torch.empty(n * buf.numel(), dtype=buf.dtype,
                                   device=buf.device)
            self._collective(pg, "all_gather", _all_gather_flat, gathered,
                             buf)
            buf.copy_(gathered.view(n, -1).prod(dim=0, dtype=buf.dtype))
        else:
            self._collective(pg, "all_reduce", dist.all_reduce, buf,
                             op=_TORCH_OP[op])

    def _p2p(self, pg, pset):
        """send, recv and exchange between set positions, for Adasum."""
        backend = dist.get_backend(pg)

        def run(name, *ops):
            self.launches[backend] += 1
            self.by_op[(backend, name)] += 1
            with self._wire_span(pg):
                for w in dist.batch_isend_irecv(list(ops)):
                    w.wait()

        def send(t, peer):
            run("send", dist.P2POp(dist.isend, t, pset.members[peer], pg))

        def recv(t, peer):
            run("recv", dist.P2POp(dist.irecv, t, pset.members[peer], pg))

        def exchange(t_out, t_in, peer):
            peer = pset.members[peer]
            run("send/recv", dist.P2POp(dist.isend, t_out, peer, pg),
                dist.P2POp(dist.irecv, t_in, peer, pg))
        return send, recv, exchange

    def _fusion_buffer(self, dtype, numel, device):
        if numel * dtype.itemsize > self.fusion_threshold:
            return torch.empty(numel, dtype=dtype, device=device)
        key = (device, dtype)
        buf = self._buffers.get(key)
        if buf is None:
            buf = torch.empty(max(self.fusion_threshold // dtype.itemsize,
                                  numel), dtype=dtype, device=device)
            self._buffers[key] = buf
        return buf[:numel]

    def _allreduce(self, entries, op, pg, n, pos, pset):
        dtype = entries[0].input.dtype
        if op == ReduceOp.ADASUM and dtype not in adasum.FLOATING:
            # Every rank decides from the negotiated dtype, before any
            # traffic (csrc/adasum.cc:79).
            raise ResponseError(
                "Adasum requires a floating-point dtype, got "
                f"{str(dtype).removeprefix('torch.')}")
        if len(entries) == 1:
            e = entries[0]
            buf = e.output.view(-1)
            if e.input is not e.output:
                self._copy(buf, e.input.reshape(-1))
            post = _post_factor(op, e.postscale, n)
            if (e.prescale != 1.0 and buf.dtype == torch.bfloat16 and
                    op in (ReduceOp.SUM, ReduceOp.AVERAGE)):
                post *= e.prescale
            else:
                self._scale(buf, e.prescale)
            with self._activity(entries, self._label):
                self._allreduce_buf(buf, op, post, pg, n, pos, pset)
            e.result = e.output
            return
        sizes = [e.input.numel() for e in entries]
        buf = self._fusion_buffer(dtype, sum(sizes),
                                  entries[0].input.device)
        parts = buf.split(sizes)
        for e, part in zip(entries, parts):
            with self._activity([e], "MEMCPY_IN_FUSION_BUFFER"):
                self._copy(part, e.input.reshape(-1))
                self._scale(part, e.prescale)
        REGISTRY.account_fusion(buf.nbytes, self.fusion_threshold)
        posts = {_post_factor(op, e.postscale, n) for e in entries}
        uniform = len(posts) == 1 and all(e.prescale == 1.0
                                          for e in entries)
        with self._activity(entries, self._label):
            self._allreduce_buf(buf, op, posts.pop() if uniform else 1.0,
                                pg, n, pos, pset)
        for e, part in zip(entries, parts):
            with self._activity([e], "MEMCPY_OUT_FUSION_BUFFER"):
                if not uniform:
                    self._scale(part, _post_factor(op, e.postscale, n))
                self._copy(e.output.view(-1), part)
            e.result = e.output

    # ---- the other collectives ----------------------------------------

    def _allgather(self, e, sizes, pg, n, pos):
        x = e.input
        rest = tuple(x.shape[1:]) if x.dim() else ()
        row = 1
        for d in rest:
            row *= d
        most = max(sizes)
        send = _wire(x).reshape(-1)
        if sizes[pos] != most:
            padded = torch.zeros(most * row, dtype=send.dtype,
                                 device=send.device)
            padded[:send.numel()].copy_(send)
            send = padded
        out = torch.empty(n * most * row, dtype=send.dtype,
                          device=send.device)
        self._collective(pg, "all_gather", _all_gather_flat, out, send)
        if any(s != most for s in sizes):
            out = torch.cat([out[i * most * row:(i * most + s) * row]
                             for i, s in enumerate(sizes)])
        if x.dtype == torch.bool:
            out = out.view(torch.bool)
        e.result = out.view((sum(sizes),) + rest)

    def _alltoall(self, e, splits, pg, pos):
        x = e.input
        rest = tuple(x.shape[1:]) if x.dim() else ()
        send = splits[pos]
        recv = [s[pos] for s in splits]
        out = torch.empty((sum(recv),) + rest, dtype=x.dtype,
                          device=x.device)
        self._collective(pg, "all_to_all", dist.all_to_all_single,
                         _wire(out), _wire(x.reshape((-1,) + rest)),
                         output_split_sizes=recv, input_split_sizes=send)
        e.result = out

    def _reducescatter(self, e, op, pg, n, pos):
        if op == ReduceOp.ADASUM:
            raise ResponseError("reducescatter does not support Adasum")
        x = e.input
        shape = tuple(x.shape) if x.dim() else (1,)
        buf = x.reshape(-1)
        if op == ReduceOp.PRODUCT or (e.prescale != 1.0 and
                                      buf.dtype in _SCALED):
            # The lane's private copy, for the paths that write their
            # input: the caller's tensor stays as it was.
            buf = buf.clone()
            self._scale(buf, e.prescale)
        q, rem = divmod(shape[0], n)
        rows = [q + (1 if r < rem else 0) for r in range(n)]
        codec = self._codec(buf.dtype, op, n)
        seg = Segments.rows(shape[0], buf.numel() // max(shape[0], 1), n)
        if codec:
            out = self._compressed_reduce_scatter(buf, seg, pg, n, pos,
                                                  codec)
        elif op == ReduceOp.PRODUCT:
            # Product keeps the allreduce's gather path (queue C).
            self._reduce_(buf, op, pg, n, pos, None)
            off = sum(rows[:pos])
            out = buf.view(shape)[off:off + rows[pos]].clone()
        else:
            out = self._exact_reduce_scatter(buf, seg, op, pg, pos)
        out = out.view((rows[pos],) + shape[1:])
        self._scale(out, _post_factor(op, e.postscale, n))
        e.result = out

    # ---- the allreduce's paths ----------------------------------------

    def _allreduce_buf(self, buf, op, post, pg, n, pos, pset):
        """In place on the 1-D ``buf``: the set's reduction, scaled by
        ``post``, on the hierarchical, the compressed or the exact
        path."""
        hops = self._hier_hops(op, n)
        if hops is not None and buf.numel():
            self._hier_allreduce(buf, op, post, *hops)
            return
        codec = self._codec(buf.dtype, op, n)
        if codec:
            self._compressed_allreduce(buf, post, pg, n, pos, codec)
            return
        self._reduce_(buf, op, pg, n, pos, pset)
        self._book_exact(op, buf, n, pos)
        self._scale(buf, post)

    def _codec(self, dtype, op, n, cross=False):
        """The codec of one hop over ``n`` ranks (0: exact): f32 Sum or
        Average only, never at one rank; bf16 on the cross hop under
        ``cross_compression``."""
        codec = wire_codec.BF16 if cross and self.cross_compression \
            else self.wire_codec
        if not codec or n <= 1 or dtype != torch.float32 or \
                op not in (ReduceOp.SUM, ReduceOp.AVERAGE):
            return 0
        return codec

    def _hier_hops(self, op, n):
        """(local, cross) SetGroups when this allreduce decomposes: the
        global set, a split tiling it into several slices, not Adasum or
        Product."""
        split = self.hier_split
        if split <= 1 or n != self.world or n % split or n // split <= 1 \
                or op in (ReduceOp.ADASUM, ReduceOp.PRODUCT):
            return None
        return self.hier_groups.get(split)

    def _book(self, tx, rx, item, compressed=None, cross=False):
        """Book one hop's wire bytes: ``tx``/``rx`` in elements at
        ``item`` bytes, or, with ``compressed`` = (tx, rx) image bytes,
        those on the wire and the elements as logical bytes."""
        logical = (tx * item, rx * item)
        REGISTRY.account_wire(*(compressed or logical), *logical, cross)

    def _book_exact(self, op, buf, n, pos, cross=False):
        """A flat exact allreduce's ring bytes (Adasum and Product book
        none)."""
        if op in (ReduceOp.ADASUM, ReduceOp.PRODUCT):
            return
        seg = Segments.even(buf.numel(), n)
        self._book(*ring_allreduce_bytes(
            [seg.count(i) for i in range(n)], pos), buf.element_size(),
            cross=cross)

    def _hier_allreduce(self, buf, op, post, local, cross):
        """``HierarchicalAllreduce``: reduce-scatter over the slice,
        allreduce of this rank's segment across the slices (the postscale
        there, once), allgather over the slice."""
        lr, n_local = local.position, local.size()
        seg = Segments.even(buf.numel(), n_local)
        lpg = local.groups[self._dev]
        codec = self._codec(buf.dtype, op, n_local)
        if codec:
            mine = self._compressed_reduce_scatter(buf, seg, lpg, n_local,
                                                   lr, codec)
        else:
            mine = self._exact_reduce_scatter(buf, seg, op, lpg, lr)
        if mine.numel():
            self._span_plane = 1
            try:
                self._cross_hop(mine, op, post, cross)
            finally:
                self._span_plane = 0
        self._exact_allgather(buf, mine, seg, lpg, lr)

    def _cross_hop(self, mine, op, post, cross):
        """The hierarchical allreduce's allreduce of this rank's segment
        across the slices (the postscale there, once)."""
        # Every rank of the cross group holds a segment of this size.
        cpg, n_cross, cr = cross.groups[self._dev], cross.size(), \
            cross.position
        ccodec = self._codec(mine.dtype, op, n_cross, cross=True)
        if ccodec:
            self._compressed_allreduce(mine, post, cpg, n_cross, cr, ccodec,
                                       cross=True)
        else:
            self._reduce_(mine, op, cpg, n_cross, cr, cross)
            self._book_exact(op, mine, n_cross, cr, cross=True)
            self._scale(mine, post)

    def _exact_reduce_scatter(self, buf, seg, op, pg, pos):
        """This rank's reduced segment of ``buf`` (a new tensor); uneven
        segments travel padded to the largest."""
        w = _wire(buf)
        n, big = seg.nseg, seg.largest
        src = w
        if 0 < seg.n_big < n:
            src = torch.zeros(n * big, dtype=w.dtype, device=w.device)
            self._scatter_rows(src.view(n, big), w, seg, into=True)
        out = torch.empty(big, dtype=w.dtype, device=w.device)
        torch_op = _BOOL_OP[op] if buf.dtype == torch.bool else _TORCH_OP[op]
        self._collective(pg, "reduce_scatter", _reduce_scatter_flat, out,
                         src, op=torch_op)
        self._book(*ring_reducescatter_bytes(
            [seg.count(i) for i in range(n)], pos), buf.element_size())
        return out[:seg.count(pos)].view(buf.dtype)

    def _exact_allgather(self, buf, mine, seg, pg, pos):
        """Every rank's segment into ``buf``; uneven segments travel
        padded to the largest."""
        wb, wm = _wire(buf), _wire(mine)
        n, big = seg.nseg, seg.largest
        if 0 < seg.n_big < n:
            send = torch.zeros(big, dtype=wm.dtype, device=wm.device)
            send[:wm.numel()].copy_(wm)
            out = torch.empty(n * big, dtype=wm.dtype, device=wm.device)
            self._collective(pg, "all_gather", _all_gather_flat, out, send)
            self._scatter_rows(out.view(n, big), wb, seg, into=False)
        else:
            self._collective(pg, "all_gather", _all_gather_flat, wb, wm)
        self._book(*ring_allgather_bytes(
            [seg.count(i) for i in range(n)], pos), buf.element_size())

    @staticmethod
    def _scatter_rows(padded, flat, seg, into):
        """Copy between the packed segments of ``flat`` and the rows of
        ``padded`` [nseg, largest]: into the rows, or out of them."""
        nb, big, small = seg.n_big, seg.big, seg.small
        pairs = ((padded[:nb], flat[:nb * big].view(nb, big)),
                 (padded[nb:, :small],
                  flat[nb * big:].view(seg.nseg - nb, small)))
        for rows, packed in pairs:
            if into:
                rows.copy_(packed)
            else:
                packed.copy_(rows)

    def _compressed_reduce_scatter(self, buf, seg, pg, n, pos, codec,
                                   cross=False):
        """This rank's segment of the f32 ``buf``, summed in f32 from the
        n ranks' images in rank order (a new tensor)."""
        img = wire_codec.encode(buf, codec, seg)
        m = seg.count(pos)
        w = image_len(m, codec)
        sizes = [image_len(seg.count(j), codec) for j in range(n)]
        recv = torch.empty(n * w, dtype=torch.uint8, device=buf.device)
        self._collective(pg, "all_to_all", dist.all_to_all_single, recv,
                         img, output_split_sizes=[w] * n,
                         input_split_sizes=sizes)
        out = torch.empty(m, dtype=torch.float32, device=buf.device)
        wire_codec.decode_scale(out, recv[:w], codec)
        wire_codec.decode_accum(out, recv[w:], codec, n - 1)
        counts = [seg.count(j) for j in range(n)]
        self._book(*exchange_bytes(counts, pos), 4,
                   compressed=exchange_bytes(sizes, pos), cross=cross)
        return out

    def _compressed_allreduce(self, buf, post, pg, n, pos, codec,
                              cross=False):
        """In place on the f32 ``buf``: the compressed reduce-scatter, the
        finished segment encoded once, an ``all_gather`` of the images in
        slots of the largest, and every segment decoded with ``post``."""
        seg = Segments.even(buf.numel(), n)
        mine = self._compressed_reduce_scatter(buf, seg, pg, n, pos, codec,
                                               cross)
        stride = image_len(seg.largest, codec)
        img = wire_codec.encode(mine, codec)
        if img.numel() < stride:
            padded = torch.zeros(stride, dtype=torch.uint8,
                                 device=buf.device)
            padded[:img.numel()].copy_(img)
            img = padded
        slots = torch.empty(n * stride, dtype=torch.uint8, device=buf.device)
        self._collective(pg, "all_gather", _all_gather_flat, slots, img)
        wire_codec.decode_scale(buf, slots, codec, seg, stride, post)
        counts = [seg.count(j) for j in range(n)]
        sizes = [image_len(c, codec) for c in counts]
        tx, rx = exchange_bytes(counts, pos)
        wtx, wrx = exchange_bytes(sizes, pos)
        self._book(rx, tx, 4, compressed=(wrx, wtx), cross=cross)
