"""The stall check of the port's lane against the reference's.

Under ``HOROVOD_STALL_CHECK_TIME=1`` rank 1 reaches a collective 3 s
after rank 0, first on a new tensor, then on a cached one (its third
use). The coordinator must warn on stderr in the reference's words,
naming the tensor and the missing rank (``tensor`` for the full
request, ``cached tensor`` for the bit), record a ``stall`` event, and
never abort: the results are still right. With
``HOROVOD_STALL_CHECK_DISABLE=1`` nothing is logged. What is checked is
what is logged, not when.
"""

import os
import re
import tempfile
import time

import numpy as np
import pytest
import torch

from tests.test_torch_hvd_cache import _Bound, open_lane, run_both
from tests.test_torch_hvd_ops import _keep
from tests.test_torch_mp import run_ranks

LATE_S = 3.0
WARNING = re.compile(
    r"Stall detected: (tensor|cached tensor) (\S+) has waited \d+s; "
    r"missing ranks: ((?:\d+ )*) \(one or more ranks did not submit this "
    r"collective\)")


def _straggle(rank, size, impl):
    """Two late arrivals of rank 1; what rank 0's stderr holds."""
    log = tempfile.TemporaryFile()
    os.dup2(log.fileno(), 2)
    hvd, _ = open_lane(impl)
    out = {}
    try:
        x = torch.from_numpy(np.arange(6, dtype=np.float32) + rank)
        if rank == 1:
            time.sleep(LATE_S)
        out["new"] = _keep(hvd.allreduce(x, name="stall.new", op=hvd.Sum))
        for step in range(3):
            if rank == 1 and step == 2:
                time.sleep(LATE_S)
            out[f"cached.{step}"] = _keep(hvd.allreduce(
                x * step, name="stall.cached", op=hvd.Sum))
        if impl == "port":
            out["events"] = [e for e in hvd.events() if e["type"] == "stall"]
    finally:
        hvd.shutdown()
    log.seek(0)
    out["log"] = log.read().decode(errors="replace")
    return out


def _warnings(text):
    return {(m.group(1), m.group(2), m.group(3)) for m in
            WARNING.finditer(text)}


@pytest.fixture(scope="module")
def straggled():
    return run_both(_straggle, 2, env={"HOROVOD_STALL_CHECK_TIME": "1"})


def test_stall_warns_in_the_reference_words(straggled):
    ref, port = straggled
    want = {("tensor", "stall.new", "1 "),
            ("cached tensor", "stall.cached", "1 ")}
    # The reference also reports a tensor in the cycle its late rank
    # arrives, naming no missing rank; the port does not.
    assert {w for w in _warnings(ref[0]["log"]) if w[2]} == want, \
        ref[0]["log"]
    assert _warnings(port[0]["log"]) == want, port[0]["log"]
    # Only the coordinator checks.
    assert not _warnings(port[1]["log"]), port[1]["log"]


def test_stall_is_an_event_and_no_abort(straggled):
    ref, port = straggled
    stalls = port[0]["events"]
    assert len(stalls) >= 2, stalls
    assert all(e["missing"] == 1 and e["waited_s"] >= 1 for e in stalls)
    for rank in range(2):
        for key in ("new", "cached.0", "cached.1", "cached.2"):
            np.testing.assert_array_equal(port[rank][key]["array"],
                                          ref[rank][key]["array"])


def test_stall_check_disable_logs_nothing():
    out = run_ranks(_Bound(_straggle, "port"), 2,
                    env={"HOROVOD_STALL_CHECK_TIME": "1",
                         "HOROVOD_STALL_CHECK_DISABLE": "1"})
    assert "Stall detected" not in out[0]["log"], out[0]["log"]
    assert out[0]["events"] == []

