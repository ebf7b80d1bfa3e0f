"""The port's controller (``horovod_tpu_torch/common/controller.py``) in
one process: readiness, fusion and its error strings, against the
reference's rules in ``csrc/controller.cc`` (``MaybePromote``,
``HandleRequestList:521``, ``BuildResponse:566``, ``FuseResponses:703``).
The mismatch messages are read from the C++ source itself.
"""

import re
from pathlib import Path

import pytest
import torch

from horovod_tpu_torch.common.controller import (
    ControlPlane,
    Controller,
    _frame,
    _unframe,
)
from horovod_tpu_torch.common.message import (
    ReduceOp,
    Request,
    RequestList,
    RequestType,
    ResponseList,
    ResponseType,
    decode,
    encode,
)
from horovod_tpu_torch.common.response_cache import ResponseCache

CSRC = Path(__file__).resolve().parent.parent / "csrc" / "controller.cc"

AR = RequestType.ALLREDUCE


def _req(rank, name, shape=(4,), dtype="float32", kind=AR, **kw):
    return Request(rank, kind, name, dtype, tuple(shape), **kw)


def _controller(size=2, threshold=64 << 20, sets=None):
    sets = {0: list(range(size)), **(sets or {})}
    return Controller(size, threshold, sets.get, ResponseCache(0))


def _negotiate(ctl, per_rank):
    """Hand each rank's requests to the controller; the response list."""
    for rank, reqs in per_rank.items():
        ctl.handle_request_list(RequestList(list(reqs)), rank)
    return ctl.fuse_responses()


def _both(ctl, *reqs_fn, size=2):
    return _negotiate(ctl, {r: [f(r) for f in reqs_fn]
                            for r in range(size)})


def _names(responses):
    return [r.tensor_names for r in responses.responses]


# ---- readiness -----------------------------------------------------------


def test_ready_only_when_every_member_asked():
    ctl = _controller(3)
    out = _negotiate(ctl, {0: [_req(0, "a")], 1: [_req(1, "a")]})
    assert out.responses == []
    out = _negotiate(ctl, {2: [_req(2, "a")]})
    assert _names(out) == [["a"]]


def test_different_enqueue_orders_agree():
    ctl = _controller(2)
    out = _negotiate(ctl, {0: [_req(0, "a"), _req(0, "b")],
                           1: [_req(1, "b"), _req(1, "a")]})
    # b completes readiness first (rank 1 asked a last): one response
    # holds both, in readiness order.
    assert _names(out) == [["b", "a"]]


def test_join_covers_missing_ranks_and_reports_the_last():
    ctl = _controller(3)
    out = _negotiate(ctl, {0: [_req(0, "a")],
                           1: [Request(1, RequestType.JOIN, "__join__")]})
    assert out.responses == []
    out = _negotiate(ctl, {2: [Request(2, RequestType.JOIN, "__join__")]})
    assert _names(out) == [["a"]]
    out = _negotiate(ctl, {0: [Request(0, RequestType.JOIN, "__join__")]})
    assert [r.response_type for r in out.responses] == [ResponseType.JOIN]
    assert out.responses[0].last_joined_rank == 0


def test_shutdown_when_every_rank_asked():
    ctl = _controller(2)
    ctl.handle_request_list(RequestList([], shutdown=True), 0)
    assert not ctl.fuse_responses().shutdown
    ctl.handle_request_list(RequestList([], shutdown=True), 1)
    assert ctl.fuse_responses().shutdown


# ---- fusion --------------------------------------------------------------


@pytest.mark.parametrize("threshold,sizes,expected", [
    # bytes of each float32 tensor; responses as tensor indices. Fold
    # the next while the total stays <= threshold (csrc FuseResponses).
    (64, [16, 16, 16, 16], [[0, 1, 2, 3]]),
    (64, [16, 16, 16, 16, 16], [[0, 1, 2, 3], [4]]),
    (48, [16, 16, 16, 16], [[0, 1, 2], [3]]),
    (64, [64, 16], [[0], [1]]),
    (64, [80, 16, 16], [[0], [1, 2]]),
    (64, [16, 60, 16], [[0], [1], [2]]),
    (256, [120] * 4, [[0, 1], [2, 3]]),
])
def test_fusion_threshold(threshold, sizes, expected):
    ctl = _controller(2, threshold)
    reqs = [lambda r, i=i, b=b: _req(r, f"t{i}", (b // 4,))
            for i, b in enumerate(sizes)]
    out = _both(ctl, *reqs)
    assert _names(out) == [[f"t{i}" for i in group] for group in expected]


def test_group_fuses_whole_past_the_threshold_and_stays_pure():
    ctl = _controller(2, threshold=32)

    def grp(i):
        return lambda r: _req(r, f"g{i}", (16,), group_id=0, group_size=3)
    out = _both(ctl, lambda r: _req(r, "before", (1,)), grp(0), grp(1),
                grp(2), lambda r: _req(r, "after", (1,)))
    assert _names(out) == [["before"], ["g0", "g1", "g2"], ["after"]]


def test_group_waits_for_all_its_members():
    ctl = _controller(2)
    out = _both(ctl, lambda r: _req(r, "g0", group_id=0, group_size=2))
    assert out.responses == []
    out = _both(ctl, lambda r: _req(r, "g1", group_id=0, group_size=2))
    assert _names(out) == [["g0", "g1"]]


@pytest.mark.parametrize("field,a,b", [
    ("dtype", "float32", "bfloat16"),
    ("reduce_op", ReduceOp.SUM, ReduceOp.MAX),
    ("process_set_id", 0, 1),
    ("device", "cpu", "cuda"),
])
def test_fusion_boundaries(field, a, b):
    ctl = _controller(2, sets={1: [0, 1]})

    def make(name, value):
        return lambda r: _req(r, name, **{field: value})
    out = _both(ctl, make("x", a), make("y", a), make("z", b),
                make("w", b))
    assert _names(out) == [["x", "y"], ["z", "w"]]


def test_adasum_never_fuses():
    ctl = _controller(2)
    out = _both(ctl, *[lambda r, i=i: _req(r, f"a{i}",
                                            reduce_op=ReduceOp.ADASUM)
                       for i in range(3)])
    assert _names(out) == [["a0"], ["a1"], ["a2"]]


def test_other_collectives_never_fuse():
    ctl = _controller(2)
    out = _both(ctl, lambda r: _req(r, "g0", kind=RequestType.ALLGATHER),
                lambda r: _req(r, "g1", kind=RequestType.ALLGATHER),
                lambda r: _req(r, "b", kind=RequestType.BROADCAST,
                               root_rank=0))
    assert _names(out) == [["g0"], ["g1"], ["b"]]


# ---- responses and their errors ------------------------------------------


def _csrc_errors():
    text = CSRC.read_text()
    body = text[text.index("Response Controller::BuildResponse"):
                text.index("ResponseList Controller::FuseResponses")]
    return set(re.findall(r'err =\s*"([^"]*)"(?:\s*"([^"]*)")*', body))


CSRC_ERRORS = {"".join(parts) for parts in _csrc_errors()}


@pytest.mark.parametrize("case,req1", [
    ("collective types", lambda: _req(1, "t", kind=RequestType.ALLGATHER)),
    ("tensor dtypes", lambda: _req(1, "t", dtype="float64")),
    ("device placement", lambda: _req(1, "t", device="cuda")),
    ("allreduce grouping", lambda: _req(1, "t", group_id=3, group_size=2)),
    ("tensor shapes across", lambda: _req(1, "t", (5,))),
])
def test_mismatch_errors_carry_the_reference_message(case, req1):
    ctl = _controller(2)
    out = _negotiate(ctl, {0: [_req(0, "t")], 1: [req1()]})
    (res,) = out.responses
    assert res.response_type == ResponseType.ERROR
    msg = res.error_message
    assert msg.startswith("tensor t: mismatched")
    assert msg.split(": ", 1)[1] in CSRC_ERRORS, (msg, CSRC_ERRORS)
    assert case in msg


@pytest.mark.parametrize("kind,shape0,shape1,root0,root1,fragment", [
    (RequestType.BROADCAST, (3,), (3,), 0, 1, "broadcast root ranks"),
    (RequestType.REDUCESCATTER, (4, 2), (5, 2), -1, -1,
     "tensor shapes across ranks"),
    (RequestType.ALLGATHER, (2, 3), (4, 2), -1, -1,
     "shapes (non-first dims)"),
    (RequestType.ALLTOALL, (2, 3), (2,), -1, -1, "shapes (non-first dims)"),
])
def test_shape_and_root_mismatches(kind, shape0, shape1, root0, root1,
                                   fragment):
    ctl = _controller(2)
    out = _negotiate(ctl, {
        0: [_req(0, "t", shape0, kind=kind, root_rank=root0)],
        1: [_req(1, "t", shape1, kind=kind, root_rank=root1)]})
    (res,) = out.responses
    assert res.response_type == ResponseType.ERROR
    assert fragment in res.error_message
    assert res.error_message.split(": ", 1)[1] in CSRC_ERRORS


def test_allgather_sizes_and_alltoall_splits():
    ctl = _controller(3)
    out = _negotiate(ctl, {r: [_req(r, "g", (r + 1, 2),
                                    kind=RequestType.ALLGATHER),
                               _req(r, "a", (6, 2), kind=RequestType.ALLTOALL,
                                    splits=(1, 2, 3) if r == 1 else None)]
                           for r in range(3)})
    g, a = out.responses
    assert g.tensor_sizes == [1, 2, 3]
    assert a.splits == [[2, 2, 2], [1, 2, 3], [2, 2, 2]]


@pytest.mark.parametrize("shape,splits,fragment", [
    ((5, 2), None, "requires first dim divisible by size"),
    ((6, 2), (1, 2), "must give one count per member"),
    ((6, 2), (1, 2, 2), "must give one count per member"),
])
def test_alltoall_split_errors(shape, splits, fragment):
    ctl = _controller(3)
    out = _negotiate(ctl, {r: [_req(r, "a", shape, kind=RequestType.ALLTOALL,
                                    splits=splits)] for r in range(3)})
    (res,) = out.responses
    assert res.response_type == ResponseType.ERROR
    assert fragment in res.error_message


def test_process_set_errors():
    ctl = _controller(3, sets={1: [0, 2]})
    out = _negotiate(ctl, {1: [_req(1, "x", process_set_id=1)],
                           0: [_req(0, "y", process_set_id=7)]})
    msgs = sorted(r.error_message for r in out.responses)
    assert msgs == ["tensor x: rank 1 is not a member of process set 1",
                    "tensor y: unknown process set 7 (add_process_set must "
                    "complete on every rank first)"]


def test_set_members_only_and_same_names_in_two_sets():
    ctl = _controller(3, sets={1: [0, 2]})
    out = _negotiate(ctl, {0: [_req(0, "x", process_set_id=1),
                               _req(0, "x")],
                           2: [_req(2, "x", process_set_id=1),
                               _req(2, "x")]})
    assert [(r.process_set_id, r.tensor_names) for r in out.responses] == \
        [(1, ["x"])]
    out = _negotiate(ctl, {1: [_req(1, "x")]})
    assert [(r.process_set_id, r.tensor_names) for r in out.responses] == \
        [(0, ["x"])]


def test_joined_rank_cannot_stand_in_for_alltoall():
    ctl = _controller(2)
    out = _negotiate(ctl, {0: [_req(0, "a", (2,), kind=RequestType.ALLTOALL)],
                           1: [Request(1, RequestType.JOIN, "__join__")]})
    assert out.responses[0].error_message == \
        "tensor a: alltoall is not supported with joined ranks"


# ---- the wire --------------------------------------------------------------


@pytest.mark.parametrize("n_requests", [0, 3, 200])
def test_frame_round_trip(n_requests):
    msg = RequestList([_req(0, f"tensor.{i}", (i, 3))
                       for i in range(n_requests)], shutdown=True)
    payload = encode(msg)
    block, rest = _frame(payload)
    assert block.dtype == torch.uint8 and block.numel() == 4096
    length, head = _unframe(block)
    assert length == len(payload)
    assert decode(head + rest) == msg


# ---- the response cache's bits -----------------------------------------


def _cached_lane(size, threshold, names, shapes, dtype="float32"):
    """A coordinator and its rank's control plane sharing one cache
    that holds ``names`` (one full negotiation, as the first step)."""
    cache = ResponseCache(16)
    ctl = Controller(size, threshold, {0: list(range(size))}.get, cache)
    plane = ControlPlane(None, 0, size, cache, ctl)
    first = _negotiate(ctl, {r: [_req(r, n, s, dtype)
                                 for n, s in zip(names, shapes)]
                             for r in range(size)})
    plane.apply_cache_verdicts(first)
    return ctl, plane


def _hits(ctl, plane, per_rank, joined=()):
    """Each rank's requests through the cache, then the verdicts."""
    evictions = []
    for r in joined:
        ctl.handle_request_list(RequestList([Request(r, RequestType.JOIN,
                                                     "__join__")]), r)
    for r, reqs in per_rank.items():
        rl = plane.build_request_list(list(reqs), False)
        ctl.handle_cache_bits(rl, r, evictions)
        ctl.handle_request_list(rl, r)
    out = ResponseList(cache_evictions=evictions)
    ctl.collect_cache_hits(out)
    out.responses = ctl.fuse_responses().responses
    plane.apply_cache_verdicts(out)
    return out


def test_cached_hits_fuse_as_requests_do():
    # 4-element f32 tensors: 16 bytes each; threshold 40 fits two.
    names = [f"h.{i}" for i in range(5)]
    ctl, plane = _cached_lane(2, 40, names, [(4,)] * 5)
    out = _hits(ctl, plane, {r: [_req(r, n) for n in names]
                             for r in range(2)})
    assert out.cache_hit_group_sizes == [2, 2, 1]
    assert _names(out) == [["h.0", "h.1"], ["h.2", "h.3"], ["h.4"]]
    assert plane.cache.hits == 10


def test_cached_bit_waits_for_every_member_or_a_join():
    ctl, plane = _cached_lane(3, 64 << 20, ["w"], [(4,)])
    out = _hits(ctl, plane, {0: [_req(0, "w")], 1: [_req(1, "w")]})
    assert out.responses == [] and out.cache_hit_positions == []
    out = _hits(ctl, plane, {}, joined=[2])
    assert _names(out)[0] == ["w"]


def test_changed_shape_evicts_and_renegotiates():
    ctl, plane = _cached_lane(2, 64 << 20, ["m"], [(4,)])
    out = _hits(ctl, plane, {r: [_req(r, "m", (6,))] for r in range(2)})
    assert out.cache_evictions == [0]
    assert [tuple(r.tensor_shapes[0]) for r in out.responses] == [(6,)]
    assert plane.cache.get(0).tensor_shapes == [(6,)]


def test_stall_check_names_missing_ranks_only(capsys):
    """A tensor waiting past the threshold is reported with the ranks
    that have not submitted it; once its last rank arrived (its response
    is built later in the same cycle) it is not."""
    import time

    ctl = Controller(2, 64 << 20, {0: [0, 1]}.get, ResponseCache(0),
                     stall_warning_s=0.001)
    ctl.handle_request_list(RequestList([_req(0, "slow")]), 0)
    time.sleep(0.01)
    ctl._last_stall_check = 0
    ctl.check_for_stalled_tensors()
    err = capsys.readouterr().err
    assert re.search(r"Stall detected: tensor slow has waited \d+s; "
                     r"missing ranks: 1  \(one or more ranks did not "
                     r"submit this collective\)", err), err
    ctl.handle_request_list(RequestList([_req(1, "slow")]), 1)
    ctl._last_stall_check = 0
    ctl.check_for_stalled_tensors()
    assert "Stall" not in capsys.readouterr().err
    assert _names(ctl.fuse_responses()) == [["slow"]]
