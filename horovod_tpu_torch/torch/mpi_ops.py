"""Eager collectives on torch tensors.

Counterpart of ``horovod_tpu/torch/mpi_ops.py:229-498``, with its names
and signatures. Each op queues one request on the lane
(``common/operations.py``) and returns a :class:`Handle`;
``synchronize`` waits for it. CUDA tensors run on NCCL in place on the
card (the reference's dlpack bridge to JAX has no counterpart), CPU
tensors on gloo.

In-place ops (``allreduce_``, ``broadcast_`` ...) write into the
caller's storage, which must be contiguous. A CPU op reads a copy of
its input taken at the call, as the reference does; a CUDA op reads its
input on the lane's stream once the stream that produced it (the
caller's current stream at the call) has reached the call, as upstream
Horovod does, so the caller does not write it until ``synchronize``.
The result of a CUDA op is ready for the caller's current stream at
``synchronize``. Unnamed ops get ``<op>.noname.<n>`` names, counted per
process in call order from the last elastic reset, so ranks that call
the same ops in the same order agree on them.

Every request is shown, as the caller enqueues it, to the callables of
:data:`OBSERVERS` (hvdlint's recorder, ``analysis/extract.py``, adds one
while it records: the lane runs the collective on its own thread, which
the recorder does not see).

The lane's instruments are re-exported from ``common/basics.py``:
``start_timeline``/``stop_timeline``, ``metrics``/``metrics_reset``,
``events`` and ``debug_port``.
"""

import operator
import threading

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import elastic as _elastic
from horovod_tpu_torch.common.message import ReduceOp, Request, RequestType

Average = ReduceOp.AVERAGE
Sum = ReduceOp.SUM
Min = ReduceOp.MIN
Max = ReduceOp.MAX
Product = ReduceOp.PRODUCT
Adasum = ReduceOp.ADASUM



def init(device=None, epoch=None, jit_fusion=None):
    """Open the lane (``common/elastic.py init``: under the elastic driver
    it first takes its epoch's rank assignment). ``jit_fusion``
    (tri-state) overrides ``HOROVOD_JIT_FUSION``, the fused ZeRO-1
    schedule's knob (``parallel/fusion.py``); None follows the
    environment."""
    if jit_fusion is not None:
        from horovod_tpu_torch.parallel import fusion

        fusion.set_jit_fusion(jit_fusion)
    _elastic.init(device, epoch=epoch)

shutdown = basics.shutdown
is_initialized = basics.is_initialized
rank = basics.rank
size = basics.size
local_rank = basics.local_rank
local_size = basics.local_size
cross_rank = basics.cross_rank
cross_size = basics.cross_size
start_timeline = basics.start_timeline
stop_timeline = basics.stop_timeline
metrics = basics.metrics
metrics_reset = basics.metrics_reset
events = basics.events
debug_port = basics.debug_port


def _make_auto_namer():
    """``auto_name(kind)``: ``<kind>.noname.<n>`` from a per-process
    counter (``horovod_tpu/common/auto_name.py``) that restarts at 0 on
    every elastic reset, so that a survivor's names match a respawned
    peer's."""
    lock = threading.Lock()
    counters = {}

    def auto_name(kind):
        with lock:
            n = counters.get(kind, 0)
            counters[kind] = n + 1
        return f"{kind}.noname.{n}"

    def _reset():
        with lock:
            counters.clear()

    _elastic.register_post_reset_hook(_reset)
    return auto_name


_auto_name = _make_auto_namer()


class Handle:
    """An in-flight op; ``synchronize()`` returns its result tensor (for
    an in-place op, the caller's tensor)."""

    def __init__(self, inner, output=None):
        self._inner = inner
        self._output = output

    def poll(self):
        return self._inner.poll()

    def synchronize(self):
        result = self._inner.wait()
        event = self._inner.cuda_event
        if event is not None:
            stream = torch.cuda.current_stream(result.device)
            stream.wait_event(event)
            if self._output is None:
                # Allocated by the lane: keep its memory from reuse
                # until the caller's stream is done with it.
                result.record_stream(stream)
        return result if self._output is None else self._output


def _device_of(tensor):
    """The lane device for ``tensor``: "cpu" (gloo) or "cuda" (NCCL, on
    this rank's card only). Never a copy from one to the other."""
    if tensor.device.type == "cpu":
        return "cpu"
    if tensor.is_cuda:
        card = basics.device()
        if card is None:
            raise ValueError(
                "a CUDA tensor on a lane opened by hvd.init(device='cpu'): "
                "that lane has no NCCL group, and a CUDA tensor is never "
                "staged through host memory")
        if tensor.device != card:
            raise ValueError(f"the tensor lies on {tensor.device}; this "
                             f"rank's lane runs on {card}")
        return "cuda"
    raise ValueError(f"the lane has no path for tensors on {tensor.device}")


#: ``observer(request, tensor, members)`` for every request as it is
#: enqueued, ``members`` the process set's global ranks.
OBSERVERS = []


def _request(kind, name, tensor, **fields):
    rt = basics.lane()
    fields["process_set_id"] = operator.index(
        fields.get("process_set_id", 0))
    req = Request(rt.rank, kind, name,
                  str(tensor.dtype).removeprefix("torch."),
                  tuple(tensor.shape), device=_device_of(tensor), **fields)
    for observe in OBSERVERS:
        observe(req, tensor, rt.members_of(req.process_set_id))
    return rt, req


def _in_place(tensor):
    t = tensor.detach()
    if not t.is_contiguous():
        raise ValueError("tensor must be contiguous for in-place collectives")
    return t


def _snapshot(tensor):
    """The op's input: a private copy for a CPU tensor (the reference's
    input snapshot), the tensor itself (contiguous) on the card."""
    t = tensor.detach()
    if t.device.type == "cpu":
        return t.clone(memory_format=torch.contiguous_format)
    return t.contiguous()


def _allreduce_item(tensor, name, op, prescale_factor, postscale_factor,
                    process_set_id, in_place, group=(-1, 0)):
    rt, req = _request(RequestType.ALLREDUCE, name, tensor, reduce_op=op,
                       prescale_factor=float(prescale_factor),
                       postscale_factor=float(postscale_factor),
                       process_set_id=process_set_id, group_id=group[0],
                       group_size=group[1])
    if in_place:
        out = _in_place(tensor)
        inp = out.clone() if req.device == "cpu" else out
    elif req.device == "cpu":
        inp = out = _snapshot(tensor)
    else:
        inp = _snapshot(tensor)
        out = torch.empty(tensor.shape, dtype=tensor.dtype,
                          device=tensor.device)
    return rt, (req, inp, out)


def allreduce_async_(tensor, name=None, op=Average, prescale_factor=1.0,
                     postscale_factor=1.0, process_set_id=0):
    """In-place async allreduce; the result lands in ``tensor``."""
    rt, item = _allreduce_item(tensor, name or _auto_name("allreduce"), op,
                               prescale_factor, postscale_factor,
                               process_set_id, True)
    return Handle(rt.enqueue(*item), output=tensor)


def allreduce_async(tensor, name=None, op=Average, prescale_factor=1.0,
                    postscale_factor=1.0, process_set_id=0):
    rt, item = _allreduce_item(tensor, name or _auto_name("allreduce"), op,
                               prescale_factor, postscale_factor,
                               process_set_id, False)
    return Handle(rt.enqueue(*item), output=item[2])


def allreduce(tensor, name=None, op=Average, prescale_factor=1.0,
              postscale_factor=1.0, process_set_id=0):
    return allreduce_async(tensor, name, op, prescale_factor,
                           postscale_factor, process_set_id).synchronize()


def allreduce_(tensor, name=None, op=Average, prescale_factor=1.0,
               postscale_factor=1.0, process_set_id=0):
    return allreduce_async_(tensor, name, op, prescale_factor,
                            postscale_factor, process_set_id).synchronize()


def _group_names(kind, names, n):
    if names is None:
        base = _auto_name(kind)
        return [f"{base}.{i}" for i in range(n)]
    names = list(names)
    if len(names) != n:
        raise ValueError(f"{kind}: {n} tensors but {len(names)} names")
    return names


def _group(rt, n):
    """(group id, size) of an atomic group of ``n`` tensors: the group
    negotiates as one, and its allreduces fuse into one response."""
    return (rt.next_group_id(), n) if n > 1 else (-1, 0)


def _grouped_allreduce(tensors, names, op, process_set_id, prescale_factor,
                       postscale_factor, in_place):
    if not tensors:
        return []
    names = _group_names("grouped_allreduce", names, len(tensors))
    group = _group(basics.lane(), len(tensors))
    items = [_allreduce_item(t, n, op, prescale_factor, postscale_factor,
                             process_set_id, in_place, group)[1]
             for t, n in zip(tensors, names)]
    handles = basics.lane().enqueue_many(items)
    return [Handle(h, output=t if in_place else item[2])
            for h, t, item in zip(handles, tensors, items)]


def grouped_allreduce_async_(tensors, names=None, op=Average,
                             process_set_id=0, prescale_factor=1.0,
                             postscale_factor=1.0):
    """In-place allreduce of a list of tensors as one atomic group."""
    return _grouped_allreduce(tensors, names, op, process_set_id,
                              prescale_factor, postscale_factor, True)


def grouped_allreduce_(tensors, names=None, op=Average, process_set_id=0,
                       prescale_factor=1.0, postscale_factor=1.0):
    return [h.synchronize() for h in grouped_allreduce_async_(
        tensors, names, op, process_set_id, prescale_factor,
        postscale_factor)]


def grouped_allreduce_async(tensors, names=None, op=Average,
                            process_set_id=0, prescale_factor=1.0,
                            postscale_factor=1.0):
    """Out-of-place allreduce of a list of tensors as one atomic group."""
    return _grouped_allreduce(tensors, names, op, process_set_id,
                              prescale_factor, postscale_factor, False)


def grouped_allreduce(tensors, names=None, op=Average, process_set_id=0,
                      prescale_factor=1.0, postscale_factor=1.0):
    return [h.synchronize() for h in grouped_allreduce_async(
        tensors, names, op, process_set_id, prescale_factor,
        postscale_factor)]


def _gather_like(kind, tensors, names, process_set_id, **fields):
    """Allgather/reducescatter items (their results are allocated by the
    lane); an atomic group when there are several."""
    rt = basics.lane()
    group = _group(rt, len(tensors))
    items = []
    for t, n in zip(tensors, names):
        _, req = _request(kind, n, t, process_set_id=process_set_id,
                          group_id=group[0], group_size=group[1], **fields)
        items.append((req, _snapshot(t), None))
    return [Handle(h) for h in rt.enqueue_many(items)]


def allgather_async(tensor, name=None, process_set_id=0):
    return _gather_like(RequestType.ALLGATHER, [tensor],
                        [name or _auto_name("allgather")], process_set_id)[0]


def allgather(tensor, name=None, process_set_id=0):
    return allgather_async(tensor, name, process_set_id).synchronize()


def grouped_allgather_async(tensors, names=None, process_set_id=0):
    """Allgather a list of tensors as one atomic negotiation group."""
    return _gather_like(
        RequestType.ALLGATHER, tensors,
        _group_names("grouped_allgather", names, len(tensors)),
        process_set_id)


def grouped_allgather(tensors, names=None, process_set_id=0):
    return [h.synchronize()
            for h in grouped_allgather_async(tensors, names, process_set_id)]


def broadcast_async_(tensor, root_rank, name=None, process_set_id=0):
    rt, req = _request(RequestType.BROADCAST,
                       name or _auto_name("broadcast"), tensor,
                       root_rank=int(root_rank),
                       process_set_id=process_set_id)
    t = _in_place(tensor)
    return Handle(rt.enqueue(req, t, t), output=tensor)


def broadcast_async(tensor, root_rank, name=None, process_set_id=0):
    out = tensor.detach().clone(memory_format=torch.contiguous_format)
    return broadcast_async_(out, root_rank, name, process_set_id)


def broadcast(tensor, root_rank, name=None, process_set_id=0):
    return broadcast_async(tensor, root_rank, name,
                           process_set_id).synchronize()


def broadcast_(tensor, root_rank, name=None, process_set_id=0):
    return broadcast_async_(tensor, root_rank, name,
                            process_set_id).synchronize()


def alltoall_async(tensor, splits=None, name=None, process_set_id=0):
    """Send ``splits[i]`` rows (equal shares when None) to the set's
    i-th member; the result stacks what each member sent, in set order."""
    if splits is not None:
        splits = tuple(int(s) for s in (splits.tolist() if hasattr(
            splits, "tolist") else splits))
    rt, req = _request(RequestType.ALLTOALL, name or _auto_name("alltoall"),
                       tensor, splits=splits, process_set_id=process_set_id)
    return Handle(rt.enqueue(req, _snapshot(tensor)))


def alltoall(tensor, splits=None, name=None, process_set_id=0):
    return alltoall_async(tensor, splits, name, process_set_id).synchronize()


def reducescatter_async(tensor, name=None, op=Average, process_set_id=0,
                        prescale_factor=1.0, postscale_factor=1.0):
    """Reduce over the set, then keep this member's rows: the first dim
    split as evenly as possible, the remainder to the lower members."""
    return _gather_like(RequestType.REDUCESCATTER, [tensor],
                        [name or _auto_name("reducescatter")],
                        process_set_id, reduce_op=op,
                        prescale_factor=float(prescale_factor),
                        postscale_factor=float(postscale_factor))[0]


def reducescatter(tensor, name=None, op=Average, process_set_id=0,
                  prescale_factor=1.0, postscale_factor=1.0):
    return reducescatter_async(tensor, name, op, process_set_id,
                               prescale_factor,
                               postscale_factor).synchronize()


def grouped_reducescatter_async(tensors, names=None, op=Average,
                                process_set_id=0):
    """Reduce-scatter a list of tensors as one atomic negotiation group."""
    return _gather_like(
        RequestType.REDUCESCATTER, tensors,
        _group_names("grouped_reducescatter", names, len(tensors)),
        process_set_id, reduce_op=op)


def grouped_reducescatter(tensors, names=None, op=Average,
                          process_set_id=0):
    return [h.synchronize() for h in grouped_reducescatter_async(
        tensors, names, op, process_set_id)]


def synchronize(handle):
    return handle.synchronize()


def poll(handle):
    return handle.poll()


def barrier(process_set_id=0):
    basics.lane().barrier(operator.index(process_set_id))


def join():
    """This rank is out of data: it contributes zeros to the other
    ranks' collectives until every rank has joined. Blocks; returns the
    last rank to join."""
    rt = basics.lane()
    return rt.enqueue(Request(rt.rank, RequestType.JOIN,
                              "__join__")).wait()
