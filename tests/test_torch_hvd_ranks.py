"""The port's Horovod eager lane against the reference at 3 and 4 ranks.

The battery of ``test_torch_hvd_ops.py`` at 3 ranks (uneven allgather,
alltoall splits and reducescatter rows, process sets of 1 and 2 of 3
ranks, join with two early ranks, Adasum with a rank folded in), and
Adasum alone at 3 and 4 ranks; the same tolerances: at 3+ ranks the
lanes sum in different orders, so floating results are held to rtol
1e-6, atol 1e-7 (f32/f64) and rtol 1e-2 (f16/bf16), integers exactly.
"""

import functools

import pytest

from tests.test_torch_hvd_ops import _adasum_battery, _battery, _compare
from tests.test_torch_mp import run_ranks


@pytest.fixture(scope="module")
def three_ranks():
    ref = run_ranks(functools.partial(_battery, impl="ref"), 3, timeout=180)
    port = run_ranks(functools.partial(_battery, impl="port"), 3,
                     timeout=180)
    return ref, port


@pytest.mark.parametrize("group", [
    "ar.", "fuse.", "ar1.", "adasum.", "inplace.", "oop.", "ag.", "bc.",
    "a2a.", "rs.", "grouped_", "ps.", "err.", "join."])
def test_three_ranks_match_reference(three_ranks, group):
    ref, port = three_ranks
    compared = 0
    for rank in range(3):
        r = {k: v for k, v in ref[rank].items() if k.startswith(group)}
        p = {k: v for k, v in port[rank].items() if k.startswith(group)}
        _compare(r, p, 3)
        compared += len(r)
    assert compared, group


def test_three_ranks_join_reports_the_last_rank(three_ranks):
    _, port = three_ranks
    assert [out["join.last"] for out in port] == [2, 2, 2]
    last = {out["last_joined_after_gather"] for out in port}
    assert len(last) == 1 and last <= {1, 2}


@pytest.mark.parametrize("size", [3, 4])
def test_adasum_matches_reference(size):
    ref = run_ranks(functools.partial(_adasum_battery, impl="ref"), size,
                    timeout=180)
    port = run_ranks(functools.partial(_adasum_battery, impl="port"), size,
                     timeout=180)
    for rank in range(size):
        _compare(ref[rank], port[rank], size)
