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
  and slices (``:600``); reducescatter reduces the whole tensor and keeps
  this member's rows, the first dim split as evenly as possible with the
  remainder to the lower positions (``:622``); alltoall sends each
  member's negotiated splits of rows.
- A set of one still makes its collective call (Adasum, with no
  partner, a one-rank sum), so that the card path is the real one.

Allreduces of a response share a fusion buffer, one per device and
dtype, allocated once at the threshold and reused; an atomic group
larger than the threshold gets its own. A lone tensor is reduced in
place in its output.

CUDA ordering: everything runs on the lane's own stream, which first
waits on the event each tensor's producer stream recorded at enqueue;
inputs and outputs are ``record_stream``-ed to it, and the caller's
stream waits on the returned completion event before it reads a result.
"""

import collections

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import adasum
from horovod_tpu_torch.common.message import ReduceOp, ResponseType

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
    buffer reads and writes it, except in a set of one)."""

    def __init__(self, device, fusion_threshold):
        self.device = device
        self.fusion_threshold = fusion_threshold
        self.stream = None
        self.launches = collections.Counter()
        self.by_op = collections.Counter()
        self.bytes_moved = 0
        # Off only in chip_smoke.py's negative control of the ordering
        # check: without the wait, a producer's late write is not seen.
        self.wait_for_producers = True
        self._buffers = {}

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
        n, pos = pset.size(), pset.position
        if kind == ResponseType.ALLREDUCE:
            self._allreduce(entries, response.reduce_op, pg, n, pos, pset)
        elif kind == ResponseType.ALLGATHER:
            self._allgather(entries[0], response.tensor_sizes, pg, n, pos)
        elif kind == ResponseType.BROADCAST:
            e = entries[0]
            self._collective(pg, "broadcast", dist.broadcast,
                             _wire(e.output), src=response.root_rank)
            e.result = e.output
        elif kind == ResponseType.ALLTOALL:
            self._alltoall(entries[0], response.splits, pg, pos)
        elif kind == ResponseType.REDUCESCATTER:
            self._reducescatter(entries[0], response.reduce_op, pg, n, pos)
        else:
            raise ValueError(f"unsupported response type {kind}")

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
            self._reduce_(buf, op, pg, n, pos, pset)
            self._scale(buf, post)
            e.result = e.output
            return
        sizes = [e.input.numel() for e in entries]
        buf = self._fusion_buffer(dtype, sum(sizes),
                                  entries[0].input.device)
        parts = buf.split(sizes)
        for e, part in zip(entries, parts):
            self._copy(part, e.input.reshape(-1))
            self._scale(part, e.prescale)
        self._reduce_(buf, op, pg, n, pos, pset)
        posts = {_post_factor(op, e.postscale, n) for e in entries}
        uniform = len(posts) == 1 and all(e.prescale == 1.0
                                          for e in entries)
        if uniform:
            self._scale(buf, posts.pop())
        for e, part in zip(entries, parts):
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
        # The lane's private copy: the caller's tensor stays as it was.
        buf = x.reshape(-1).clone()
        self._scale(buf, e.prescale)
        self._reduce_(buf, op, pg, n, pos, None)
        q, rem = divmod(shape[0], n)
        rows = [q + (1 if r < rem else 0) for r in range(n)]
        off = sum(rows[:pos])
        out = buf.view(shape)[off:off + rows[pos]].clone()
        self._scale(out, _post_factor(op, e.postscale, n))
        e.result = out
