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
    requests: list = dataclasses.field(default_factory=list)
    shutdown: bool = False


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
    responses: list = dataclasses.field(default_factory=list)
    shutdown: bool = False


def encode(msg):
    return pickle.dumps(msg, protocol=pickle.HIGHEST_PROTOCOL)


def decode(data):
    return pickle.loads(data)
