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

The steady state rides the response cache (``response_cache.py``): a
request whose response is cached travels as its position's bit
(``BuildRequestList:777``); the coordinator completes a position once
every member has sent its bit or joined (``HandleCacheBits:811``),
fuses consecutive ready hits as it fuses requests
(``CollectCacheHits:838``), and every rank evicts, rebuilds the hits'
responses from its own copy and inserts the new responses in the same
order (``ApplyCacheVerdicts:903``). The coordinator also warns on
stderr of a tensor some rank has not submitted within
``HOROVOD_STALL_CHECK_TIME`` (``CheckForStalledTensors:947``), and
counts which rank completed each tensor last (the straggler table).

Under ``HOROVOD_AUTOTUNE`` the coordinator's tuner moves the fusion
threshold (:meth:`Controller.set_autotuned_params`, the reference's
``SetAutotunedParams``): the controller fuses with the new value from
the next cycle on, and every response list from then carries it, the
cycle time, the wire codec and the hierarchy split to the workers;
untuned, the list carries 0 for the first two and -1 for the others.

A lost peer ends the lane (``operations.py``); re-forming the world is
``basics.reinit``'s, with a new controller. Still to port (ROADMAP.md):
the control tree and wire checksums (L8), the MPI controller (L9).
"""

import collections
import struct
import sys

import torch
import torch.distributed as dist

from horovod_tpu_torch.common import events
from horovod_tpu_torch.common import response_cache as rc
from horovod_tpu_torch.common.message import (
    ReduceOp,
    RequestList,
    RequestType,
    Response,
    ResponseList,
    ResponseType,
    decode,
    encode,
    nbytes,
    response_bytes,
)
from horovod_tpu_torch.common.metrics import REGISTRY, now_us


class _Pending:
    """A tensor's full requests so far, and when its first came."""

    __slots__ = ("requests", "ranks_seen", "queued", "first_seen",
                 "first_round")

    def __init__(self, round_):
        self.requests = []
        self.ranks_seen = set()
        self.queued = False
        self.first_seen = now_us()
        self.first_round = round_


class _PendingBits:
    """A cached position's bits so far (``PendingBits``)."""

    __slots__ = ("ranks", "first_seen", "first_round", "last_rank")

    def __init__(self, round_):
        self.ranks = set()
        self.first_seen = now_us()
        self.first_round = round_
        self.last_rank = -1


def _fusable(a, b):
    """Whether two allreduces may share a fused response
    (``FusableAllreducePair``)."""
    return ((a.tensor_type, a.process_set_id, a.reduce_op, a.device) ==
            (b.tensor_type, b.process_set_id, b.reduce_op, b.device))


def _missing(members, seen, joined):
    # The reference's "r r " list, trailing space and all.
    return [m for m in members if m not in seen and m not in joined]


class Controller:
    """The coordinator's negotiation state, kept across cycles.

    ``members_of(process_set_id)`` gives a set's sorted global ranks, or
    None for a set this rank does not know. ``cache`` is this rank's
    :class:`~response_cache.ResponseCache`; ``stall_warning_s`` the
    stall check's threshold (None: off)."""

    def __init__(self, size, fusion_threshold, members_of, cache,
                 stall_warning_s=60.0):
        self.size = size
        self.fusion_threshold = fusion_threshold
        self._members_of = members_of
        self.cache = cache
        self.stall_warning_s = stall_warning_s
        self.round = 0
        self._last_stall_check = now_us()
        self._bits = {}                       # position -> _PendingBits
        self._table = {}                      # (set, name) -> _Pending
        self._ready = collections.deque()     # keys, in readiness order
        self._groups = {}                     # (set, group id) -> keys
        self._joined = set()
        self._last_joined = -1
        self._shutdown = [False] * size
        # What each response list tells the workers (0: not tuned).
        self.bcast_fusion_bytes = 0
        self.bcast_cycle_ms = 0.0
        self.bcast_wire_codec = self.bcast_hier_split = -1

    def set_autotuned_params(self, fusion_bytes, cycle_ms, wire_codec=-1,
                             hier_split=-1):
        """The tuner's new knobs: fuse with ``fusion_bytes`` from now on,
        and send all four to the workers in every later response list."""
        self.fusion_threshold = self.bcast_fusion_bytes = int(fusion_bytes)
        self.bcast_cycle_ms = float(cycle_ms)
        self.bcast_wire_codec = int(wire_codec)
        self.bcast_hier_split = int(hier_split)

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
            pt = self._table.get(key)
            if pt is None:
                pt = self._table[key] = _Pending(self.round)
            if req.request_rank in pt.ranks_seen:
                continue
            pt.ranks_seen.add(req.request_rank)
            pt.requests.append(req)
            was_queued = pt.queued
            self._maybe_promote(key, pt)
            if (not was_queued and pt.queued and len(pt.ranks_seen) > 1 and
                    self.round > pt.first_round):
                # Completed in a later round than its first request: this
                # rank kept the tensor waiting.
                REGISTRY.record_straggler(req.request_rank,
                                          now_us() - pt.first_seen)
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

    # ---- the response cache's bits ------------------------------------

    def handle_cache_bits(self, request_list, from_rank, evictions):
        """Note ``from_rank``'s cache bits; an invalid bit evicts its
        position everywhere (``evictions``, in first-seen order)."""
        for pos in request_list.cache_invalid:
            if pos not in evictions:
                evictions.append(pos)
            self._bits.pop(pos, None)
        for pos in request_list.cache_hits:
            # A bit of a position evicted meanwhile is dropped: its
            # sender resubmits the full request on the eviction.
            if not self.cache.has(pos) or pos in evictions:
                continue
            pb = self._bits.get(pos)
            if pb is None:
                pb = self._bits[pos] = _PendingBits(self.round)
            if from_rank not in pb.ranks:
                pb.ranks.add(from_rank)
                pb.last_rank = from_rank

    def collect_cache_hits(self, out):
        """Move every position whose set is complete (bits or joins) to
        ``out``, in position order, consecutive fusable allreduces
        grouped up to the threshold. Runs before :meth:`fuse_responses`,
        whose all-joined cycle clears the joins these rely on."""
        completed = []
        for pos in sorted(self._bits):
            pb = self._bits[pos]
            r = self.cache.get(pos)
            if _missing(self._members_of(r.process_set_id) or (), pb.ranks,
                        self._joined):
                continue
            completed.append(pos)
            if len(pb.ranks) > 1 and self.round > pb.first_round:
                REGISTRY.record_straggler(pb.last_rank,
                                          now_us() - pb.first_seen)
        i = 0
        while i < len(completed):
            r0 = self.cache.get(completed[i])
            group = 1
            if r0.response_type == ResponseType.ALLREDUCE:
                size = response_bytes(r0)
                while i + group < len(completed):
                    rn = self.cache.get(completed[i + group])
                    if (rn.response_type != ResponseType.ALLREDUCE or
                            not _fusable(rn, r0)):
                        break
                    nsize = response_bytes(rn)
                    if size + nsize > self.fusion_threshold:
                        break
                    size += nsize
                    group += 1
            for pos in completed[i:i + group]:
                out.cache_hit_positions.append(pos)
                del self._bits[pos]
            out.cache_hit_group_sizes.append(group)
            i += group

    def check_for_stalled_tensors(self):
        """Warn on stderr, and record a ``stall`` event, for every tensor
        some member has not submitted within the threshold, at most
        every ``min(10, max(0.1, threshold / 2))`` s. Never aborts. Unlike
        the reference, a tensor missing no rank is not reported."""
        if self.stall_warning_s is None:
            return
        now = now_us()
        interval = min(10.0, max(0.1, self.stall_warning_s / 2))
        if now - self._last_stall_check < interval * 1e6:
            return
        self._last_stall_check = now
        stalled = []
        for pt in self._table.values():
            first = pt.requests[0]
            stalled.append(("tensor", first.tensor_name, pt.first_seen,
                            first.process_set_id, pt.ranks_seen))
        for pos, pb in self._bits.items():
            if self.cache.has(pos):
                r = self.cache.get(pos)
                stalled.append(("cached tensor", r.tensor_names[0],
                                pb.first_seen, r.process_set_id, pb.ranks))
        for what, name, first_seen, ps, seen in stalled:
            waited = (now - first_seen) / 1e6
            if waited <= self.stall_warning_s:
                continue
            missing = _missing(self._members_of(ps) or (), seen,
                               self._joined)
            if not missing:
                # Completed this cycle (its response is built next), or a
                # group member whose peers are reported themselves.
                continue
            events.record("stall", int(waited), len(missing))
            print(f"[hvdtpu WARN] Stall detected: {what} {name} has waited "
                  f"{waited:.0f}s; missing ranks: "
                  f"{''.join(f'{r} ' for r in missing)} (one or more ranks "
                  "did not submit this collective)", file=sys.stderr,
                  flush=True)

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
                            not _fusable(nreq, first)):
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
    response list from rank 0 (broadcast). Every rank holds a response
    cache (``cache``); only the coordinator has a :class:`Controller`,
    which shares rank 0's cache."""

    def __init__(self, group, rank, size, cache, controller=None):
        self.group = group
        self.rank = rank
        self.size = size
        self.cache = cache
        self.controller = controller
        self._inflight_hits = {}     # position -> Request sent as a bit
        self._resubmit = []

    def build_request_list(self, requests, shutdown):
        """This cycle's list through the cache (``BuildRequestList``): a
        hit travels as its bit, an invalid entry as its bit and its full
        request; requests whose bit was evicted in flight go again."""
        out = RequestList(shutdown=shutdown)
        requests, self._resubmit = self._resubmit + requests, []
        for req in requests:
            if req.request_type == RequestType.JOIN:
                out.requests.append(req)
                continue
            verdict, pos = self.cache.lookup(req)
            if verdict == rc.HIT:
                out.cache_hits.append(pos)
                self._inflight_hits[pos] = req
            else:
                if verdict == rc.INVALID:
                    out.cache_invalid.append(pos)
                out.requests.append(req)
        return out

    def apply_cache_verdicts(self, response_list):
        """On every rank, in this order: evict, rebuild the hits'
        responses from this rank's copy, insert the new responses; the
        hits run first (``ApplyCacheVerdicts``)."""
        for pos in response_list.cache_evictions:
            self.cache.evict(pos)
            req = self._inflight_hits.pop(pos, None)
            if req is not None:
                self._resubmit.append(req)
        hits = []
        positions = iter(response_list.cache_hit_positions)
        for group in response_list.cache_hit_group_sizes:
            group = [next(positions) for _ in range(group)]
            first = self.cache.get(group[0])
            merged = Response(
                response_type=first.response_type,
                tensor_names=[self.cache.get(p).tensor_names[0]
                              for p in group],
                tensor_type=first.tensor_type,
                tensor_shapes=[self.cache.get(p).tensor_shapes[0]
                               for p in group],
                reduce_op=first.reduce_op, root_rank=first.root_rank,
                process_set_id=first.process_set_id, device=first.device)
            for p in group:
                self._inflight_hits.pop(p, None)
            hits.append(merged)
        self.cache.insert_from_responses(response_list.responses)
        response_list.responses[:0] = hits

    def exchange(self, requests, shutdown):
        """One cycle's negotiation; the responses to run, in order."""
        block, rest = _frame(encode(self.build_request_list(requests,
                                                            shutdown)))
        t_gather = now_us()
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
            ctl = self.controller
            ctl.round += 1
            evictions = []
            for r, (length, head) in enumerate(heads):
                body = head
                if length > len(head):
                    body += tails[r].numpy().tobytes()[:length - len(head)]
                request_list = decode(body)
                ctl.handle_cache_bits(request_list, r, evictions)
                ctl.handle_request_list(request_list, r)
            gather_us = now_us() - t_gather
            ctl.check_for_stalled_tensors()
            out = ResponseList(cache_evictions=evictions,
                               fusion_threshold_bytes=ctl.bcast_fusion_bytes,
                               cycle_time_ms=ctl.bcast_cycle_ms,
                               wire_compression=ctl.bcast_wire_codec,
                               hier_split=ctl.bcast_hier_split)
            ctl.collect_cache_hits(out)
            fused = ctl.fuse_responses()
            out.responses, out.shutdown = fused.responses, fused.shutdown
            # Idle cycles stay on the histograms but out of the ring.
            busy = bool(out.responses or out.cache_hit_positions or
                        out.cache_evictions)
            REGISTRY.record_phase("gather", gather_us, busy)
            payload = encode(out)
        else:
            payload = b""
        t_bcast = now_us()
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
        if self.rank == 0:
            REGISTRY.record_phase("broadcast", now_us() - t_bcast, busy)
        response_list = decode(head)
        self.apply_cache_verdicts(response_list)
        return response_list
