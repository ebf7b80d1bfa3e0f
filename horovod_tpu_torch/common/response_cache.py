"""The response cache: the negotiation's steady state.

Counterpart of ``csrc/response_cache.{h,cc}``. After a tensor's first
full negotiation every rank caches its single-tensor response at an
agreed position; later cycles send the position's bit instead of the
full request (:class:`~message.RequestList` ``cache_hits``), and the
coordinator completes a position once every member of its process set
has sent the bit or joined. Insertions and evictions are driven only by
the broadcast :class:`~message.ResponseList`, in its order, so every
rank's cache stays identical with no extra round.

What is cached follows the reference (``response_cache.cc:37
Eligible``): allreduce except Adasum, broadcast and reducescatter.
Allgather (data-dependent first dims), join, barrier and grouped
(atomic) responses are never cached. The reference caches alltoall on
its device plane only, where every rank sends equal splits; the port's
CUDA alltoall takes any splits, so the port caches no alltoall
(``ROADMAP.md`` "Deliberate differences").
"""

import bisect
import sys

from horovod_tpu_torch.common.message import (
    ReduceOp,
    Response,
    ResponseType,
    response_bytes,
)

MISS, HIT, INVALID = 0, 1, 2

_CACHED = (ResponseType.ALLREDUCE, ResponseType.BROADCAST,
           ResponseType.REDUCESCATTER)


def _eligible(res):
    if res.response_type not in _CACHED or res.group_id >= 0:
        return False
    return not (res.response_type == ResponseType.ALLREDUCE and
                res.reduce_op == ReduceOp.ADASUM)


class ResponseCache:
    """``capacity`` positions (``HOROVOD_CACHE_CAPACITY``; 0 disables)."""

    def __init__(self, capacity):
        self.capacity = capacity
        self._slots = []        # position -> (key, Response) or None
        self._free = []         # free positions, ascending
        self._index = {}        # (process set, name) -> position
        self._warned_full = False
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0

    @property
    def enabled(self):
        return self.capacity > 0

    @property
    def entries(self):
        return len(self._index)

    def lookup(self, req):
        """``(MISS | HIT | INVALID, position)`` of an outgoing request.
        INVALID: the name is cached with other metadata; the coordinator
        evicts it everywhere and the full request renegotiates."""
        if not self.enabled or req.group_id >= 0:
            # A group's bits could not keep it atomic.
            self.misses += 1
            return MISS, -1
        pos = self._index.get((req.process_set_id, req.tensor_name))
        if pos is None:
            self.misses += 1
            return MISS, -1
        r = self._slots[pos][1]
        match = (r.response_type == req.request_type and
                 r.tensor_type == req.tensor_type and
                 r.device == req.device and
                 tuple(r.tensor_shapes[0]) == tuple(req.tensor_shape))
        if match and r.response_type in (ResponseType.ALLREDUCE,
                                         ResponseType.REDUCESCATTER):
            match = r.reduce_op == req.reduce_op
        elif match and r.response_type == ResponseType.BROADCAST:
            match = r.root_rank == req.root_rank
        if match:
            self.hits += 1
            self.hit_bytes += response_bytes(r)
            return HIT, pos
        self.misses += 1
        return INVALID, pos

    def insert_from_responses(self, responses):
        """Cache each eligible tensor of a broadcast response list, a
        fused response split per tensor, in list order, at the smallest
        free position. Every rank calls this with the same list in the
        same cycle."""
        if not self.enabled:
            return
        for res in responses:
            if not _eligible(res):
                continue
            for name, shape in zip(res.tensor_names, res.tensor_shapes):
                key = (res.process_set_id, name)
                if key in self._index:
                    continue
                if self._free:
                    pos = self._free.pop(0)
                elif len(self._slots) < self.capacity:
                    pos = len(self._slots)
                    self._slots.append(None)
                else:
                    if not self._warned_full:
                        self._warned_full = True
                        print(f"[hvdtpu WARN] response cache full "
                              f"({self.capacity} entries); further tensors "
                              "take the full negotiation path every cycle. "
                              "Raise HOROVOD_CACHE_CAPACITY.",
                              file=sys.stderr, flush=True)
                    return
                self._slots[pos] = (key, Response(
                    response_type=res.response_type, tensor_names=[name],
                    tensor_type=res.tensor_type,
                    tensor_shapes=[tuple(shape)], reduce_op=res.reduce_op,
                    root_rank=res.root_rank,
                    process_set_id=res.process_set_id, device=res.device))
                self._index[key] = pos

    def evict(self, pos):
        if not self.has(pos):
            return
        key, _ = self._slots[pos]
        del self._index[key]
        self._slots[pos] = None
        bisect.insort(self._free, pos)

    def has(self, pos):
        return 0 <= pos < len(self._slots) and self._slots[pos] is not None

    def get(self, pos):
        """The single-tensor response cached at ``pos`` (``has(pos)``)."""
        return self._slots[pos][1]

    def state(self):
        """Every position's (key, response), for comparing two caches."""
        return list(self._slots), list(self._free)
