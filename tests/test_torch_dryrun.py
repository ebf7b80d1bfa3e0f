"""The port's multi-rank dryrun (``python -m horovod_tpu_torch.dryrun 8``)
against the reference's ``__graft_entry__.py:389 dryrun_multichip``.

One run of the module on 8 spawned ranks: it exits 0, says where it
ran (the CPU over gloo without eight cards), and prints each of the
reference's eleven passes, in its order, the three pipeline passes
among them, as matching the port's unsharded step. (On four cards
``tests/test_torch_mesh_cuda_ranks.py`` runs it with NCCL.) The mesh
split (``_mesh_axes_for``) is the reference's, and an odd rank count is
refused as the reference refuses it.
"""

import subprocess
import sys

import pytest

from horovod_tpu_torch import dryrun
from tests.utils_mp import REPO_ROOT

PASSES = ("dense/dp.fsdp.tp.sp", "dense/ulysses-sp", "dense/split-accum2",
          "dense/zero1", "dense/hier", "moe/ep.tp.fsdp",
          *dryrun.PIPELINE_PASSES, "resnet/dp.sync-bn", "bert/mlm.tp.fsdp")


def test_module_runs_every_non_pipeline_pass_on_eight_ranks():
    proc = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.dryrun", "8"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    where = "8 CUDA cards (NCCL)" if dryrun.pick_device(8) == "cuda" \
        else "8 ranks on the CPU (gloo)"
    assert proc.stdout.splitlines()[0] == f"dryrun_multichip: {where}"
    lines = [l for l in proc.stdout.splitlines()
             if l.startswith("dryrun_multichip[")]
    by_pass = {l.split("[", 1)[1].split("]", 1)[0]: l for l in lines}
    assert list(by_pass) == list(PASSES)
    for name in PASSES:
        assert " ok (" in by_pass[name] and "match" in by_pass[name], \
            by_pass[name]
    assert "bit-matches psum" in by_pass["dense/hier"]
    assert "params match replicated" in by_pass["dense/zero1"]
    for name in dryrun.PIPELINE_PASSES:
        assert "'pipe': 2" in by_pass[name], by_pass[name]


@pytest.mark.parametrize("n,axes,fixed", [
    (8, ("seq", "tensor", "fsdp"), None),
    (8, ("tensor", "fsdp"), {"expert": 2}),
    (8, ("tensor", "fsdp"), None),
    (4, ("seq", "tensor", "fsdp"), None),
    (16, ("tensor", "fsdp"), {"pipe": 2})])
def test_mesh_axes_for_is_the_reference_split(n, axes, fixed):
    import __graft_entry__ as ref

    assert dryrun._mesh_axes_for(n, axes, fixed) == \
        ref._mesh_axes_for(n, axes, fixed)


def test_odd_counts_are_refused():
    import __graft_entry__ as ref

    for fn in (dryrun._mesh_axes_for, ref._mesh_axes_for):
        with pytest.raises(ValueError, match="multiple of 2"):
            fn(7)
    with pytest.raises(ValueError, match="even number"):
        dryrun.dryrun_multichip(7)
