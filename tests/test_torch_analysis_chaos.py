"""The port's chaos-spec validator (``horovod_tpu_torch/analysis/
chaos.py``) against the JAX package's ``validate_chaos_spec`` and the
port's own lane parse (``common/operations.py parse_fault_spec``), on
the reference's corpus and on hypothesis-drawn specs.

Agreement with the lane: a spec validates iff the lane's parse does not
return None (malformed, disarmed). The wire actions ``stop``, ``reset``
and ``flip`` validate as grammar while the lane raises on them, naming
ROADMAP L8; ``kill`` and ``delay`` arm with the validated fields.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from horovod_tpu.analysis import chaos as jchaos
from horovod_tpu_torch.analysis import chaos
from horovod_tpu_torch.common.operations import parse_fault_spec

_VALID = (
    "0:3", "1:5:kill", "0:2:stop:40", "1:0:reset", "1:0:reset:3",
    "0:1:flip:17", "0:1:flip:-9", "0:1:flip:5:2", "0:1:flip:5:2:3",
    "0:4:delay:25", " 0: 3",
)

_INVALID = (
    "", "0", "x:0", "-1:0", "0:-1", "0:0:nope", "0:0:kill:1",
    "0:0:stop", "0:0:stop:0", "0:0:delay:0", "0:0:reset:8",
    "0:0:reset:-1", "0:0:flip", "0:0:flip:1048576", "0:0:flip:-1:2",
    "0:0:flip:1:-1", "0:0:flip:1:16777216", "0:0:flip:1:2:8",
    "0:0:flip:1:2:-1", "0:0:stop:5:1", "0:0:kill:1:2:3",
    "0:0:flip:1:2:3:4", "0x1:3", "9223372036854775808:3",
)


def _port(spec):
    try:
        return chaos.validate_chaos_spec(spec)
    except chaos.ChaosSpecError:
        return None


def _reference(spec):
    try:
        return jchaos.validate_chaos_spec(spec)
    except jchaos.ChaosSpecError:
        return None


def _lane(spec):
    """The lane's verdict: None (disarmed), ``("wire", action)`` for
    the L8 actions it refuses, or the armed tuple."""
    try:
        return parse_fault_spec(spec)
    except ValueError as e:
        assert "L8" in str(e), e
        return ("wire", spec.split(":")[2])


def _agree(spec):
    got, want, lane = _port(spec), _reference(spec), _lane(spec)
    assert (got is None) == (want is None), spec
    if got is not None:
        assert (got.rank, got.op, got.action, got.param) == (
            want.rank, want.op, want.action, want.param), spec
    assert (got is None) == (lane is None), (spec, got, lane)
    if got is None:
        return
    if got.action in ("stop", "reset", "flip"):
        assert lane == ("wire", got.action), spec
    else:
        assert lane == (got.rank, got.op, got.action, got.param), spec


@pytest.mark.parametrize("spec", _VALID + _INVALID)
def test_corpus_agrees_with_the_reference_and_the_lane(spec):
    _agree(spec)
    assert (_port(spec) is not None) == (spec in _VALID)


def test_flip_packing_and_properties():
    fs = chaos.validate_chaos_spec("0:1:flip:5:2:3")
    assert fs.param == 5 | (2 << chaos.FLIP_SKIP_SHIFT) \
        | ((3 + 1) << chaos.FLIP_CHAN_SHIFT)
    assert (fs.flip_bit, fs.flip_skip, fs.flip_channel) == (5, 2, 3)
    assert chaos.validate_chaos_spec("0:1:flip:5:2").flip_channel is None
    assert chaos.validate_chaos_spec("0:1:flip:-9").param == -9
    for name in ("ACTIONS", "MAX_WIRE_CHANNELS", "FLIP_SKIP_SHIFT",
                 "FLIP_CHAN_SHIFT", "FLIP_BIT_MASK", "FLIP_SKIP_MASK"):
        assert getattr(chaos, name) == getattr(jchaos, name), name


_NUM = st.one_of(
    st.integers(-3, 40).map(str),
    st.sampled_from(["", "+1", "-0", " 7", "1 ", "0x1", "1048575",
                     "1048576", "16777215", "16777216",
                     "9223372036854775807", "9223372036854775808",
                     "-9223372036854775809", "\t3", "٣"]))
_ACTION = st.sampled_from(["kill", "stop", "reset", "flip", "delay",
                           "nope", "", "KILL"])


@st.composite
def _specs(draw):
    fields = [draw(_NUM), draw(_NUM)]
    if draw(st.booleans()):
        fields.append(draw(_ACTION))
        fields += draw(st.lists(_NUM, max_size=4))
    return ":".join(fields)


@settings(max_examples=400, deadline=None)
@given(_specs())
def test_drawn_specs_agree_with_the_reference_and_the_lane(spec):
    _agree(spec)


@settings(max_examples=200, deadline=None)
@given(st.text(alphabet="0123456789:-+ kilstopredflyaxn", max_size=24))
def test_drawn_text_agrees_with_the_reference_and_the_lane(spec):
    _agree(spec)
