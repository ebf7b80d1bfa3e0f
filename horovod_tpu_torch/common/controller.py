"""Negotiation: which collectives are ready on every rank, in what order,
and which of them fuse.

Counterpart of ``csrc/controller.cc``. Every cycle each rank sends the
requests it newly queued to the coordinator (rank 0) over the control
group (:class:`ControlPlane`); the coordinator's :class:`Controller`
marks a tensor ready once every member of its process set (or a joined
rank in its place) has asked for it (``HandleRequestList:521``), turns
each ready tensor into a response, or an error when the ranks disagree
(``BuildResponse:566``), fuses ready allreduces up to the threshold
(``FuseResponses:703``), and every rank receives the same
:class:`~message.ResponseList`. Ranks may enqueue in different orders
and still run the same collectives in the same order.

The response cache (ROADMAP.md L1), the stall check (L2) and the
control tree with wire checksums (L8) are not ported.
"""

import collections
import struct

import torch
import torch.distributed as dist

from horovod_tpu_torch.common.message import (
    ReduceOp,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
    decode,
    encode,
)


def dtype_size(name):
    """Bytes per element of the torch dtype called ``name``."""
    return getattr(torch, name).itemsize


def nbytes(dtype_name, shape):
    n = 1
    for d in shape:
        n *= d
    return n * dtype_size(dtype_name)


class _Pending:
    __slots__ = ("requests", "ranks_seen", "queued")

    def __init__(self):
        self.requests = []
        self.ranks_seen = set()
        self.queued = False


class Controller:
    """The coordinator's negotiation state, kept across cycles.

    ``members_of(process_set_id)`` gives a set's sorted global ranks, or
    None for a set this rank does not know."""

    def __init__(self, size, fusion_threshold, members_of):
        self.size = size
        self.fusion_threshold = fusion_threshold
        self._members_of = members_of
        self._table = {}                      # (set, name) -> _Pending
        self._ready = collections.deque()     # keys, in readiness order
        self._groups = {}                     # (set, group id) -> keys
        self._joined = set()
        self._last_joined = -1
        self._shutdown = [False] * size

    @staticmethod
    def key(req):
        # Keyed by (process set, name): disjoint sets may run
        # same-named collectives at once.
        return (req.process_set_id, req.tensor_name)

    def handle_request_list(self, request_list, from_rank):
        if request_list.shutdown:
            self._shutdown[from_rank] = True
        new_join = False
        for req in request_list.requests:
            if req.request_type == RequestType.JOIN:
                if req.request_rank not in self._joined:
                    self._joined.add(req.request_rank)
                    self._last_joined = req.request_rank
                    new_join = True
                continue
            key = self.key(req)
            pt = self._table.setdefault(key, _Pending())
            if req.request_rank in pt.ranks_seen:
                continue
            pt.ranks_seen.add(req.request_rank)
            pt.requests.append(req)
            self._maybe_promote(key, pt)
        if new_join:
            # A join can complete readiness of any pending tensor.
            for key, pt in list(self._table.items()):
                self._maybe_promote(key, pt)

    def _maybe_promote(self, key, pt):
        if pt.queued:
            return
        first = pt.requests[0]
        members = self._members_of(first.process_set_id)
        # An unknown set or a requester outside the set is promoted at
        # once, so that _build_response reports it instead of the tensor
        # waiting forever.
        if members and all(r in members for r in pt.ranks_seen):
            for r in members:
                if r not in pt.ranks_seen and r not in self._joined:
                    return
        pt.queued = True
        # Ranks that disagree on the grouping get the mismatch error,
        # not a wait for group members that never come.
        if any(r.group_id != first.group_id or
               r.group_size != first.group_size for r in pt.requests):
            self._ready.append(key)
            return
        if first.group_id >= 0 and first.group_size > 1:
            # Hold a group's members until the whole group is ready, then
            # release them together so they fuse into one pure response.
            gkey = (first.process_set_id, first.group_id)
            keys = self._groups.setdefault(gkey, [])
            keys.append(key)
            if len(keys) >= first.group_size:
                self._ready.extend(keys)
                del self._groups[gkey]
            return
        self._ready.append(key)

    def _error(self, res, msg):
        res.response_type = ResponseType.ERROR
        res.error_message = f"tensor {res.tensor_names[0]}: {msg}"
        return res

    def _build_response(self, key):
        pt = self._table[key]
        first = pt.requests[0]
        res = Response(
            response_type=first.request_type,
            tensor_names=[first.tensor_name],
            tensor_type=first.tensor_type,
            tensor_shapes=[tuple(first.tensor_shape)],
            reduce_op=first.reduce_op, root_rank=first.root_rank,
            process_set_id=first.process_set_id, device=first.device,
            group_id=first.group_id)
        members = self._members_of(first.process_set_id)
        if not members:
            return self._error(
                res, f"unknown process set {first.process_set_id} "
                "(add_process_set must complete on every rank first)")
        for req in pt.requests:
            if req.request_rank not in members:
                return self._error(
                    res, f"rank {req.request_rank} is not a member of "
                    f"process set {first.process_set_id}")
        # A member missing from ranks_seen was covered by a join; an
        # alltoall needs real splits from every member.
        if (first.request_type == RequestType.ALLTOALL and
                any(r not in pt.ranks_seen for r in members)):
            return self._error(res, "alltoall is not supported with "
                               "joined ranks")
        err = ""
        for req in pt.requests:
            if req.request_type != first.request_type:
                err = "mismatched collective types across ranks"
            elif req.tensor_type != first.tensor_type:
                err = "mismatched tensor dtypes across ranks"
            elif req.process_set_id != first.process_set_id:
                err = "mismatched process sets across ranks"
            elif req.device != first.device:
                err = "mismatched device placement across ranks"
            elif (req.group_id != first.group_id or
                  req.group_size != first.group_size):
                err = ("mismatched allreduce grouping across ranks "
                       "(grouped calls must happen in the same order on "
                       "every rank)")
            elif req.request_type in (RequestType.ALLREDUCE,
                                      RequestType.BROADCAST,
                                      RequestType.REDUCESCATTER):
                if tuple(req.tensor_shape) != tuple(first.tensor_shape):
                    err = "mismatched tensor shapes across ranks"
                if (req.request_type == RequestType.BROADCAST and
                        req.root_rank != first.root_rank):
                    err = "mismatched broadcast root ranks"
            elif req.request_type in (RequestType.ALLGATHER,
                                      RequestType.ALLTOALL):
                if (len(req.tensor_shape) != len(first.tensor_shape) or
                        tuple(req.tensor_shape[1:]) !=
                        tuple(first.tensor_shape[1:])):
                    err = ("mismatched tensor shapes (non-first dims) "
                           "across ranks")
            if err:
                return self._error(res, err)
        if (first.request_type == RequestType.BROADCAST and
                first.root_rank not in members):
            return self._error(
                res, f"broadcast root rank {first.root_rank} is not a "
                f"member of process set {first.process_set_id}")
        if first.request_type == RequestType.ALLGATHER:
            # First-dim sizes per member in set order (joined stay 0).
            by_rank = {r.request_rank: (r.tensor_shape[0] if r.tensor_shape
                                        else 1) for r in pt.requests}
            res.tensor_sizes = [by_rank.get(m, 0) for m in members]
        elif first.request_type == RequestType.ALLTOALL:
            return self._alltoall_splits(res, pt.requests, members)
        return res

    def _alltoall_splits(self, res, requests, members):
        n = len(members)
        by_rank = {}
        for req in requests:
            first_dim = req.tensor_shape[0] if req.tensor_shape else 1
            if req.splits is None:
                if first_dim % n:
                    return self._error(
                        res, "alltoall without splits requires first dim "
                        "divisible by size")
                splits = [first_dim // n] * n
            else:
                splits = [int(s) for s in req.splits]
                if (len(splits) != n or sum(splits) != first_dim or
                        min(splits) < 0):
                    return self._error(
                        res, f"alltoall splits {splits} of rank "
                        f"{req.request_rank} must give one count per "
                        f"member of the set ({n}) summing to its first "
                        f"dim {first_dim}")
            by_rank[req.request_rank] = splits
        res.splits = [by_rank[m] for m in members]
        return res

    def fuse_responses(self):
        """Turn the ready queue into this cycle's response list."""
        out = ResponseList()
        while self._ready:
            key = self._ready.popleft()
            res = self._build_response(key)
            first = self._table[key].requests[0]
            # Fold the following ready allreduces of the same dtype, set,
            # reduce op and device into this response while under the
            # threshold. An atomic group fuses whole, past the threshold,
            # and stays pure; Adasum normalises per tensor and never fuses.
            if (res.response_type == ResponseType.ALLREDUCE and
                    first.reduce_op != ReduceOp.ADASUM):
                size = nbytes(first.tensor_type, first.tensor_shape)
                while self._ready:
                    nkey = self._ready[0]
                    nreq = self._table[nkey].requests[0]
                    same_group = (first.group_id >= 0 and
                                  nreq.group_id == first.group_id and
                                  nreq.process_set_id ==
                                  first.process_set_id)
                    if first.group_id >= 0 and not same_group:
                        break
                    if first.group_id < 0 and nreq.group_id >= 0:
                        break
                    if (nreq.request_type != RequestType.ALLREDUCE or
                            (nreq.tensor_type, nreq.process_set_id,
                             nreq.reduce_op, nreq.device) !=
                            (first.tensor_type, first.process_set_id,
                             first.reduce_op, first.device)):
                        break
                    nres = self._build_response(nkey)
                    if nres.response_type == ResponseType.ERROR:
                        break
                    nsize = nbytes(nreq.tensor_type, nreq.tensor_shape)
                    if not same_group and (
                            size >= self.fusion_threshold or
                            size + nsize > self.fusion_threshold):
                        break
                    res.tensor_names.append(nreq.tensor_name)
                    res.tensor_shapes.append(tuple(nreq.tensor_shape))
                    size += nsize
                    del self._table[nkey]
                    self._ready.popleft()
            del self._table[key]
            out.responses.append(res)
        if len(self._joined) == self.size:
            # Every rank joined: complete each rank's pending join.
            out.responses.append(Response(
                response_type=ResponseType.JOIN, tensor_names=["__join__"],
                last_joined_rank=self._last_joined))
            self._joined.clear()
            self._last_joined = -1
        out.shutdown = all(self._shutdown)
        return out


# A cycle's message is a fixed-size block: an 8-byte length, then the
# first bytes of the payload; a longer payload sends its remainder in a
# second collective. So a quiet cycle costs two small collectives.
_BLOCK = 4096
_HEAD = struct.Struct("<q")


def _frame(payload):
    block = bytearray(_BLOCK)
    _HEAD.pack_into(block, 0, len(payload))
    first = payload[:_BLOCK - _HEAD.size]
    block[_HEAD.size:_HEAD.size + len(first)] = first
    return torch.frombuffer(block, dtype=torch.uint8), \
        payload[_BLOCK - _HEAD.size:]


def _unframe(block):
    raw = block.numpy().tobytes()
    (length,) = _HEAD.unpack_from(raw, 0)
    return length, raw[_HEAD.size:_HEAD.size + min(length,
                                                   _BLOCK - _HEAD.size)]


class ControlPlane:
    """One negotiation per cycle over the control group (gloo): every
    rank's request list to every rank (all-gather), the coordinator's
    response list from rank 0 (broadcast). Only the coordinator has a
    :class:`Controller`."""

    def __init__(self, group, rank, size, controller=None):
        self.group = group
        self.rank = rank
        self.size = size
        self.controller = controller

    def exchange(self, request_list):
        block, rest = _frame(encode(request_list))
        blocks = [torch.empty(_BLOCK, dtype=torch.uint8)
                  for _ in range(self.size)]
        dist.all_gather(blocks, block, group=self.group)
        heads = [_unframe(b) for b in blocks]
        extra = max(length for length, _ in heads) - (_BLOCK - _HEAD.size)
        if extra > 0:
            tail = torch.zeros(extra, dtype=torch.uint8)
            if rest:
                tail[:len(rest)] = torch.frombuffer(bytearray(rest),
                                                    dtype=torch.uint8)
            tails = [torch.empty(extra, dtype=torch.uint8)
                     for _ in range(self.size)]
            dist.all_gather(tails, tail, group=self.group)
        if self.rank == 0:
            for r, (length, head) in enumerate(heads):
                body = head
                if length > len(head):
                    body += tails[r].numpy().tobytes()[:length - len(head)]
                self.controller.handle_request_list(decode(body), r)
            payload = encode(self.controller.fuse_responses())
        else:
            payload = b""
        block, rest = _frame(payload)
        dist.broadcast(block, src=0, group=self.group)
        length, head = _unframe(block)
        if length > len(head):
            tail = torch.zeros(length - len(head), dtype=torch.uint8)
            if self.rank == 0:
                tail.copy_(torch.frombuffer(bytearray(rest),
                                            dtype=torch.uint8))
            dist.broadcast(tail, src=0, group=self.group)
            head += tail.numpy().tobytes()
        return decode(head)
