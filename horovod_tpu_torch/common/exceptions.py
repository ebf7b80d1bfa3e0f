"""Framework-agnostic exceptions.

The port's own copy of ``horovod_tpu/common/exceptions.py``, with the
same classes and fields, so that code written against the reference
catches the port's errors unchanged. The port raises
:class:`HorovodInternalError` for a failed collective (a mismatch across
ranks, a shutdown mid-flight) and its subclass
:class:`HorovodPeerFailureError` for a lost peer, naming it;
:class:`HorovodWireCorruptionError` waits for the wire's CRC
(ROADMAP.md L8).
"""


class HorovodInternalError(RuntimeError):
    """Internal error raised when a collective fails (peer death, shape
    mismatch, shutdown mid-flight). Elastic mode catches this to roll back
    to the last committed state."""


class HorovodPeerFailureError(HorovodInternalError):
    """A specific peer died or went unresponsive mid-collective.

    ``fault_ranks`` are the global ranks declared dead, ``epoch`` the
    membership epoch that faulted and ``detect_ms`` how long the failing
    operation ran before the error surfaced.
    """

    def __init__(self, message, fault_ranks=(), epoch=0, detect_ms=None):
        super().__init__(message)
        self.fault_ranks = tuple(fault_ranks)
        self.epoch = epoch
        self.detect_ms = detect_ms


class HorovodWireCorruptionError(HorovodPeerFailureError):
    """A checksummed wire chunk failed verification past the retry
    budget; ``chunk`` names the failing chunk."""

    def __init__(self, message, fault_ranks=(), epoch=0, detect_ms=None,
                 chunk=None):
        super().__init__(message, fault_ranks=fault_ranks, epoch=epoch,
                         detect_ms=detect_ms)
        self.chunk = chunk


class HorovodStateLostError(HorovodInternalError):
    """Rows of a sharded state (a ZeRO carry's blocks) that no rank of
    the re-formed world holds and no durable commit has. ``lost`` maps
    each sharded state (its path in the elastic state) to the
    ``(start, stop)`` flat element ranges lost in each bucket. The
    port's own: ``hvd.elastic.run`` re-raises it instead of retrying,
    since another reset cannot bring the rows back."""

    def __init__(self, message, lost=None):
        super().__init__(message)
        self.lost = dict(lost or {})


class HorovodReformationError(RuntimeError):
    """A state or program whose layout is tied to the world's shape (a
    ZeRO carry under a mesh, or split across planes) met a re-formation
    that changed that shape, or the groups its axes ran on. The port's
    own; not retried by ``hvd.elastic.run``."""


class HostsUpdatedInterrupt(Exception):
    """Raised in elastic mode when the host set changed; ``skip_sync``
    is True when the worker set only grew."""

    def __init__(self, skip_sync=False):
        super().__init__()
        self.skip_sync = skip_sync


class HorovodVersionMismatchError(ImportError):
    """Frontend/core version skew detected at import time."""
