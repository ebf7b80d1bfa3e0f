"""What the ranks negotiate: requests, responses and their lists.

Counterpart of ``csrc/message.{h,cc}``. A rank sends one
:class:`RequestList` per cycle (the collectives it newly queued, and
whether it wants to shut down); the coordinator answers every rank with
the same :class:`ResponseList`. Dtypes travel as torch dtype names
(``"float32"``), devices as ``"cpu"`` or ``"cuda"``.

On the wire a list is pickled: the bytes come only from this program's
own ranks over its control group.
"""

import dataclasses
import pickle

import torch


class RequestType:
    ALLREDUCE = 0
    ALLGATHER = 1
    BROADCAST = 2
    ALLTOALL = 3
    REDUCESCATTER = 4
    BARRIER = 5
    JOIN = 6


class ResponseType(RequestType):
    ERROR = 7


class ReduceOp:
    """Reduction ops (``horovod_tpu/common/eager_ops.py:41``)."""

    AVERAGE = 0
    SUM = 1
    MIN = 2
    MAX = 3
    PRODUCT = 4
    ADASUM = 5


@dataclasses.dataclass
class Request:
    """One rank's request to run a named collective."""

    request_rank: int
    request_type: int
    tensor_name: str
    tensor_type: str = ""
    tensor_shape: tuple = ()
    reduce_op: int = ReduceOp.SUM
    prescale_factor: float = 1.0
    postscale_factor: float = 1.0
    root_rank: int = -1
    process_set_id: int = 0
    device: str = "cpu"
    group_id: int = -1
    group_size: int = 0
    splits: tuple = None


@dataclasses.dataclass
class RequestList:
    """One rank's cycle: its new full requests, whether it wants to shut
    down, and the response cache's bits (``csrc/message.h:131-138``):
    ``cache_hits`` the cached positions of tensors it is ready to run,
    ``cache_invalid`` cached positions whose name now comes with other
    metadata (their full request is in ``requests`` too)."""

    requests: list = dataclasses.field(default_factory=list)
    shutdown: bool = False
    cache_hits: list = dataclasses.field(default_factory=list)
    cache_invalid: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Response:
    """One collective to run, the same on every rank. An allreduce
    response may carry several tensors (fused); ``tensor_sizes`` are an
    allgather's first dims per member in set order, ``splits`` an
    alltoall's send splits per member."""

    response_type: int
    tensor_names: list = dataclasses.field(default_factory=list)
    tensor_type: str = ""
    tensor_shapes: list = dataclasses.field(default_factory=list)
    reduce_op: int = ReduceOp.SUM
    root_rank: int = -1
    process_set_id: int = 0
    device: str = "cpu"
    group_id: int = -1
    tensor_sizes: list = None
    splits: list = None
    error_message: str = ""
    last_joined_rank: int = -1


@dataclasses.dataclass
class ResponseList:
    """The coordinator's answer, the same on every rank: newly negotiated
    responses, and the cache's verdicts (``csrc/message.h:175-180``):
    positions ready on every member, ``cache_hit_group_sizes``
    partitioning them into fused responses (``[3, 1]``: the first three
    fuse, the fourth runs alone), and positions every rank evicts
    first. ``fusion_threshold_bytes`` and ``cycle_time_ms`` are the
    autotuner's knobs, which every worker adopts before it runs the
    list's responses (0: not tuned, keep the local value), and so are
    ``wire_compression`` (the codec, 0-2) and ``hier_split``
    (``csrc/message.h:163-168``; -1: not tuned)."""

    responses: list = dataclasses.field(default_factory=list)
    shutdown: bool = False
    cache_hit_positions: list = dataclasses.field(default_factory=list)
    cache_hit_group_sizes: list = dataclasses.field(default_factory=list)
    cache_evictions: list = dataclasses.field(default_factory=list)
    fusion_threshold_bytes: int = 0
    cycle_time_ms: float = 0.0
    wire_compression: int = -1
    hier_split: int = -1


def dtype_size(name):
    """Bytes per element of the torch dtype called ``name``."""
    return getattr(torch, name).itemsize


def nbytes(dtype_name, shape):
    n = 1
    for d in shape:
        n *= d
    return n * dtype_size(dtype_name)


def response_bytes(res):
    """Payload bytes of every tensor of ``res`` (``ShapesTotalBytes``);
    0 for a barrier, which carries no dtype. The autotuner scores the
    allreduce responses' (``ResponseBytes``)."""
    if not res.tensor_type:
        return 0
    return sum(nbytes(res.tensor_type, s) for s in res.tensor_shapes)


def encode(msg):
    return pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)


def decode(data):
    return pickle.loads(data)
