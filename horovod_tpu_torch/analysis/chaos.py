"""Static validation of the ``HOROVOD_FAULT_INJECT`` chaos grammar.

The port's own copy of ``horovod_tpu/analysis/chaos.py``. A malformed
spec keeps the trigger disarmed (the lane's parse,
``common/operations.py parse_fault_spec``, returns None for it, as the
reference's C ``ParseFaultSpec`` does), because a lenient parse that read
garbage as ``0:0`` would kill rank 0 at its first collective. Strictness
has a flip side: a typo'd spec in a CI chaos job silently tests
*nothing*. This module rejects a bad spec, with the reason, *before* a
multi-rank job launches::

    from horovod_tpu_torch import analysis
    analysis.validate_chaos_spec("1:5:delay:200")     # -> FaultSpec
    analysis.validate_chaos_spec("1:5:flip:17:")      # ChaosSpecError

Grammar (the reference's)::

    <rank>:<op>[:<action>[:<param>[:<skip>[:<chan>]]]]

    kill                 hard-exit at collective #op (no param)
    stop:<ms>            freeze ms > 0 (the stalled-not-dead shape)
    reset[:<chan>]       RST peer sockets; optional single stripe chan
    flip:<bit>           corrupt one wire frame (negative = persistent)
    flip:<bit>:<skip>    ... after skipping <skip> data frames
    flip:<bit>:<skip>:<chan>  ... counting only on one stripe channel
    delay:<ms>           inject a straggler stall ms > 0

The numeric fields follow C ``strtoll`` base 10: optional leading
whitespace and sign, full consume required; a value that overflows int64
is rejected. On every spec, the validator and ``parse_fault_spec`` agree
on what is well formed. The wire actions ``stop``, ``reset`` and
``flip`` validate as grammar here, while the port's lane still raises on
them: they act on the reference's socket wire (its deadline and CRC
framing, ROADMAP.md L8), which the port does not have; ``kill`` and
``delay`` arm.
"""

import dataclasses
import re

# The reference's FaultAction order (kill=0 .. delay=4).
ACTIONS = ("kill", "stop", "reset", "flip", "delay")

# The reference's stripe-channel bound (its kMaxWireChannels).
MAX_WIRE_CHANNELS = 8

# flip's packed param layout (the reference's kFlipSkipShift /
# kFlipChanShift): low 20 bits = bit index, bits 20..43 = frames to
# skip before flipping, bits 44+ = (stripe channel + 1), 0 = no filter.
FLIP_SKIP_SHIFT = 20
FLIP_CHAN_SHIFT = 44
FLIP_BIT_MASK = (1 << FLIP_SKIP_SHIFT) - 1
FLIP_SKIP_MASK = (1 << (FLIP_CHAN_SHIFT - FLIP_SKIP_SHIFT)) - 1

_INT64_MAX = (1 << 63) - 1

# strtoll base 10 with mandatory full consume: optional leading
# whitespace, optional sign, digits, nothing after.
_INT_RE = re.compile(r"[ \t\n\v\f\r]*[+-]?[0-9]+\Z")


class ChaosSpecError(ValueError):
    """A HOROVOD_FAULT_INJECT spec the lane would leave disarmed."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A validated fault-inject spec, fields as the C core decodes them.

    ``param`` carries the packed value the reference's ``ParseFaultSpec``
    produces (for ``flip`` the bit/skip/chan fields are packed; the
    ``flip_*`` properties unpack them again).
    """

    rank: int
    op: int
    action: str
    param: int

    @property
    def flip_bit(self):
        if self.action != "flip":
            return None
        return self.param if self.param < 0 else self.param & FLIP_BIT_MASK

    @property
    def flip_skip(self):
        if self.action != "flip" or self.param < 0:
            return None
        return (self.param >> FLIP_SKIP_SHIFT) & FLIP_SKIP_MASK

    @property
    def flip_channel(self):
        """Stripe channel filter, or None when unfiltered."""
        if self.action != "flip" or self.param < 0:
            return None
        chan = self.param >> FLIP_CHAN_SHIFT
        return chan - 1 if chan > 0 else None


def _parse_i64(field, text):
    if not text:
        raise ChaosSpecError(f"{field}: empty numeric field")
    if not _INT_RE.match(text):
        raise ChaosSpecError(
            f"{field}: {text!r} is not a base-10 integer "
            "(strtoll full-consume)")
    v = int(text)
    if not -_INT64_MAX - 1 <= v <= _INT64_MAX:
        raise ChaosSpecError(f"{field}: {text!r} overflows int64")
    return v


def validate_chaos_spec(spec):
    """Validate a ``HOROVOD_FAULT_INJECT`` spec string.

    Returns a :class:`FaultSpec` on success; raises
    :class:`ChaosSpecError` (a ``ValueError``) with the reason the lane
    would leave the trigger disarmed on failure. Accept/reject agrees
    with ``common.operations.parse_fault_spec`` on every spec (pinned
    by tests/test_torch_analysis_chaos.py).
    """
    if not isinstance(spec, str):
        raise ChaosSpecError(f"spec must be a string, got {type(spec)!r}")
    parts = spec.split(":")
    if len(parts) < 2 or len(parts) > 6:
        raise ChaosSpecError(
            f"expected <rank>:<op>[:<action>[:<param>[:<skip>[:<chan>]]]], "
            f"got {len(parts)} field(s)")
    rank = _parse_i64("rank", parts[0])
    if rank < 0:
        raise ChaosSpecError(f"rank: must be >= 0, got {rank}")
    op = _parse_i64("op", parts[1])
    if op < 0:
        raise ChaosSpecError(f"op: must be >= 0, got {op}")
    if len(parts) >= 5 and parts[2] != "flip":
        raise ChaosSpecError(
            f"only flip takes <skip>/<chan> fields, not {parts[2]!r}")

    action = "kill"
    param = 0
    has_param = len(parts) >= 4
    if len(parts) >= 3:
        action = parts[2]
        if action == "kill":
            if has_param:
                raise ChaosSpecError("kill takes no param")
        elif action in ("stop", "delay"):
            param = _parse_i64("ms", parts[3]) if has_param else None
            if param is None or param <= 0:
                raise ChaosSpecError(f"{action} requires a positive ms param")
        elif action == "reset":
            param = -1
            if has_param:
                param = _parse_i64("chan", parts[3])
                if not 0 <= param < MAX_WIRE_CHANNELS:
                    raise ChaosSpecError(
                        f"reset channel must be in [0, {MAX_WIRE_CHANNELS}), "
                        f"got {param}")
        elif action == "flip":
            if not has_param:
                raise ChaosSpecError("flip requires a bit index")
            param = _parse_i64("bit", parts[3])
            # A non-negative bit must fit the packed low field even
            # WITHOUT a skip (negative = persistent |bit|, never
            # packed).
            if param > FLIP_BIT_MASK:
                raise ChaosSpecError(
                    f"flip bit must be <= {FLIP_BIT_MASK}, got {param}")
            if len(parts) >= 5:
                if param < 0:
                    raise ChaosSpecError(
                        "persistent (negative-bit) flip cannot take "
                        "<skip>/<chan> — one-shot only")
                skip = _parse_i64("skip", parts[4])
                if not 0 <= skip <= FLIP_SKIP_MASK:
                    raise ChaosSpecError(
                        f"flip skip must be in [0, {FLIP_SKIP_MASK}], "
                        f"got {skip}")
                param |= skip << FLIP_SKIP_SHIFT
                if len(parts) == 6:
                    chan = _parse_i64("chan", parts[5])
                    if not 0 <= chan < MAX_WIRE_CHANNELS:
                        raise ChaosSpecError(
                            f"flip channel must be in "
                            f"[0, {MAX_WIRE_CHANNELS}), got {chan}")
                    param |= (chan + 1) << FLIP_CHAN_SHIFT
        else:
            raise ChaosSpecError(
                f"unknown action {action!r} "
                f"(expected one of {', '.join(ACTIONS)})")
    return FaultSpec(rank=rank, op=op, action=action, param=param)
