"""hvdlint's shipped-program registry on the port against the JAX
package's (``horovod_tpu_torch/analysis/programs.py`` against
``horovod_tpu/analysis/programs.py``), on the CPU.

- **Explicit-collective programs** (the ZeRO applies, the fused ZeRO
  step, the composed-plane allreduce, the redistribute program, the
  three pipelines, the ring): the port's ordered signature (prim, axes,
  elements, dtype) of rank 0 equals JAX's ``extract(...).signature``,
  linearized, on the same config and geometry, and
  ``predict.collective_bytes`` JAX's, but for the differences each test
  names: the reduce-scatter's spelling, the fused step's bucket order,
  the pipelines' bubble slots and batched exchanges.
- **GSPMD programs** (the monolithic step and the split steps): each
  lints clean in both packages; the port's ZeRO split step's bytes are
  its ``eager_zero_bytes``; the monolithic step is also linted on a real
  fake mesh, ``data=2 x fsdp=2 x tensor=2``.
- The two MoE programs at ``tiny_moe``, the CLI, the redistribute plan
  through C5, and the fusion smoke's C7 gate.
"""

import collections

import jax
import pytest
import torch
import torch.distributed as dist

from horovod_tpu.analysis import programs as jprograms
from horovod_tpu.analysis.extract import extract as jextract
from horovod_tpu.analysis.extract import linearize as jlinearize
from horovod_tpu.telemetry import predict as jpredict
from horovod_tpu_torch.analysis import programs
from horovod_tpu_torch.analysis.extract import extract
from horovod_tpu_torch.analysis.pytest_plugin import (  # noqa: F401
    hvdlint_shipped,
)
from horovod_tpu_torch.parallel import pipeline
from horovod_tpu_torch.telemetry import predict


@pytest.fixture(autouse=True)
def _no_world():
    """As ``tests/test_torch_analysis_lint.py``'s: no world left over,
    torch on one thread while a test runs."""
    if dist.is_initialized() and dist.get_world_size() == 1:
        dist.destroy_process_group()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()


def _norm(prim):
    # JAX 0.9 spells the reduce-scatter ``reduce_scatter``; the port's
    # recorder (and JAX's own C5) ``psum_scatter``.
    return "psum_scatter" if prim in ("psum_scatter", "reduce_scatter") \
        else prim


def _rows(sig):
    return [(_norm(c.prim), tuple(c.axes), c.nelems, c.dtype) for c in sig]


def _jax_signature(name):
    spec = jprograms.build_program(name)
    closed = jax.make_jaxpr(spec.fn, axis_env=spec.axis_env)(*spec.args)
    sig = jlinearize(jextract(closed).signature)
    jbytes = jpredict.collective_bytes(spec.fn, *spec.args,
                                       axis_env=spec.axis_env)
    return _rows(sig), jbytes


def _port_signature(name, via_collective_bytes=False):
    """Rank 0's rows and bytes; ``via_collective_bytes`` takes the bytes
    from ``predict.collective_bytes`` (its own run of the program)."""
    spec = programs.build_program(name)
    ex = extract(spec.fn, spec.args, axis_env=spec.axis_env, ranks=(0,))
    pbytes = predict.signature_bytes(ex.signature)
    if via_collective_bytes:
        assert predict.collective_bytes(
            spec.fn, spec.args, axis_env=spec.axis_env) == pbytes
    return _rows(ex.signature), pbytes


def _bytes(rows):
    return sum(n * getattr(torch, dt).itemsize for _, _, n, dt in rows)


def test_registry_names_match_the_jax_package():
    assert programs.program_names() == jprograms.program_names()
    assert len(programs.program_names()) == 15


@pytest.mark.parametrize("name", ["zero1_shard_apply",
                                  "zero1_shard_apply_hier",
                                  "hier_allreduce",
                                  "redistribute_to_replicated",
                                  "ring_attention_sp"])
def test_explicit_program_signature_equals_jax(name):
    """The same collectives in the same order, the same elements and
    dtypes, the same bytes: no difference to name beyond the
    reduce-scatter's spelling."""
    want, jbytes = _jax_signature(name)
    got, pbytes = _port_signature(name, via_collective_bytes=True)
    assert got == want
    assert pbytes == jbytes


def test_fused_zero_step_signature_equals_jax_up_to_bucket_order():
    """Named difference: the same 10 reduce-scatters and 10 all-gathers,
    all scatters first in both, but in another bucket order. JAX's
    ``interleave_collectives`` emits each scatter where its reordered
    jaxpr completes the bucket; the port's hook issues it where the eager
    backward completes it. In both, the gathers follow their scatters'
    order (gather i is scatter i's shard)."""
    want, jbytes = _jax_signature("zero1_fused_step")
    got, pbytes = _port_signature("zero1_fused_step")
    assert sorted(got) == sorted(want) and got != want
    assert pbytes == jbytes
    for rows in (got, want):
        n = len(rows) // 2
        assert all(r[0] == "psum_scatter" for r in rows[:n])
        assert all(r[0] == "all_gather" for r in rows[n:])
        assert [r[2] for r in rows[n:]] == [r[2] // 4 for r in rows[:n]]


def _slot_counts(name):
    S, M, V = programs._S, programs._M, programs._V
    if name == "pipeline_gpipe":
        return pipeline._stage_exchanges(pipeline.gpipe_plan(S, M), S, 1, 0)
    if name == "pipeline_1f1b":
        return pipeline._stage_exchanges(pipeline.lockstep_plan(S, M), S,
                                         1, 0)
    sched = pipeline.build_interleaved_schedule(S, V, M)
    return pipeline._stage_exchanges(pipeline.interleaved_plan(sched), S,
                                     V, 0)


@pytest.mark.parametrize("name", ["pipeline_gpipe", "pipeline_1f1b",
                                  "pipeline_interleaved_1f1b"])
def test_pipeline_signature_equals_jax_but_the_named_differences(name):
    """Named differences, stage 0's sequence against JAX's per-device
    program:

    - **bubble slots**: JAX's scan makes its ring hop every slot (the
      bubble's values computed and masked); the port's slot walker
      exchanges nothing where the stage has nothing to send or receive;
    - **one batch a slot**: JAX's 1F1B engines hop a forward and a
      backward carry a slot (two ``ppermute``); the port posts a slot's
      messages in one ``batch_isend_irecv`` (one ``ppermute`` a send, or
      a receive where there are more);
    - **the tail**: the same psums, the loss shared first (JAX: last but
      the aux), and the activations' (gpipe) or ``d_xs``' (1F1B) share
      in the compute dtype, bf16 (JAX casts its CPU carry to f32)."""
    want, _ = _jax_signature(name)
    got, pbytes = _port_signature(name)
    hops = 1 if name == "pipeline_gpipe" else 2
    counts = _slot_counts(name)
    jpp = [r for r in want if r[0] == "ppermute"]
    assert len(jpp) == hops * len(counts)
    # Each slot's exchanges are JAX's hops of that slot, fewer or none.
    assert all(0 <= c <= hops for c in counts) and 0 in counts
    expect = []
    for u, c in enumerate(counts):
        expect += jpp[u * hops:u * hops + c]
    tail = [r for r in want if r[0] != "ppermute"]
    act = 2048   # the [M, mb, T, d] activations (gpipe) or d_xs (1F1B)
    tail = [(p, a, n, "bfloat16" if n == act else dt)
            for p, a, n, dt in tail]
    if name != "pipeline_gpipe":
        # JAX's tail: d_hp..., d_xs, loss, aux; the port's: loss first.
        tail = [tail[-2]] + tail[:-2] + [tail[-1]]
    assert got == expect + tail
    assert pbytes == _bytes(expect + tail)
    assert [r[:2] for r in got] == pipeline.predicted_collectives(
        name.removeprefix("pipeline_"), S=programs._S, M=programs._M,
        num_virtual=programs._V if "interleaved" in name else 1)


_GSPMD = ["llama_train_step", "llama_train_step_split",
          "llama_train_step_split_fused_adam",
          "llama_train_step_split_fused_master_adam",
          "llama_train_step_split_telemetry",
          "llama_train_step_split_zero1"]


@pytest.mark.parametrize("name", _GSPMD)
def test_gspmd_program_lints_clean_in_both_packages(hvdlint_shipped, name):
    assert jprograms.lint_program(name) == []
    hvdlint_shipped(name)


def test_zero_split_step_bytes_are_its_eager_zero_bytes():
    """The ZeRO split step's recorded reduce-scatters and all-gathers,
    booked as the lane's counters book them (``zero_signature_bytes``:
    a gather at its gathered width), are ``eager_zero_bytes`` of the
    same loss, params, batch and layout."""
    spec = programs.build_program("llama_train_step_split_zero1")
    ex = extract(spec.fn, spec.args, axis_env=spec.axis_env, ranks=(0,))
    rows = _rows(ex.signature)
    assert {r[0] for r in rows} == {"psum_scatter", "all_gather"}
    cfg = programs._config("tiny")
    want = predict.eager_zero_bytes(
        programs._loss_fn(cfg, None), programs._params(cfg),
        programs._batch(cfg), size=programs._ZERO_SHARDS,
        bucket_bytes=1 << 20)
    assert predict.zero_signature_bytes(ex.signature,
                                        programs._ZERO_SHARDS) == want


def test_monolithic_step_on_a_real_fake_mesh_lints_clean():
    """``data=2 x fsdp=2 x tensor=2``: each rank's blocks and batch
    shard, the model's gathers and sums over the mesh's groups recorded
    for rank 0 and its peer on each axis (ranks 4, 2 and 1); no
    divergence, every group a declared axis.

    What JAX's GSPMD step hides and the port's explicit one shows, held
    here as found: FSDP's gradient reduce-scatters keep the gradients
    sharded after the params' gathers (C6, allowlisted as the check's
    hint says for state kept sharded on purpose), and they, and the
    ``data`` sums of the replicated leaves' gradients, reduce at f32
    the gradients of bf16 compute (C3 warnings: f32 params, bf16
    activations)."""
    from horovod_tpu_torch.analysis import api

    spec = programs._monolithic("tiny", axis_env=[("data", 2), ("fsdp", 2),
                                                  ("tensor", 2)])
    assert programs._peers(spec.axis_env) == (0, 1, 2, 4)
    ex = extract(spec.fn, spec.args, axis_env=spec.axis_env,
                 ranks=programs._peers(spec.axis_env))
    prims = collections.Counter(c.prim for c in ex.signature)
    assert prims["all_gather"] and prims["psum"] and prims["psum_scatter"]
    assert {a for c in ex.signature for a in c.axes} == {
        "data", "fsdp", "tensor"}
    diags = api.check(ex, spec.axis_env)
    assert [d.id for d in diags if d.id != "C3"] == ["C6"]
    assert "fsdp" in next(d for d in diags if d.id == "C6").message
    assert all(d.severity == "warning" and "upcast from bfloat16"
               in d.message for d in diags if d.id == "C3")
    assert api.check(ex, spec.axis_env, allow=("C3", "C6")) == []


@pytest.mark.parametrize("name", ["llama_train_step",
                                  "pipeline_interleaved_1f1b"])
def test_shipped_moe_program_is_clean(hvdlint_shipped, name):
    assert jprograms.lint_program(name, config="tiny_moe") == []
    hvdlint_shipped(name, config="tiny_moe")


def test_cli_single_program_list_and_exit_codes(capsys, monkeypatch):
    from horovod_tpu_torch.analysis.lint import main

    assert main(["--program", "pipeline_gpipe"]) == 0
    assert "pipeline_gpipe: clean" in capsys.readouterr().out
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == programs.program_names()

    def unpaired(config):
        from horovod_tpu_torch.parallel.ops import reduce_scatter

        return programs.LintSpec(
            fn=lambda mesh, x: reduce_scatter(x, mesh.axis_group("data")),
            args=lambda mesh: (mesh, torch.ones(8)),
            axis_env=[("data", 2)])

    monkeypatch.setitem(programs._REGISTRY, "unpaired", unpaired)
    assert main(["--program", "unpaired"]) == 1
    assert "C6 error" in capsys.readouterr().out
    assert main(["--program", "unpaired", "--allow", "C6"]) == 0


def test_redistribute_plan_through_c5():
    """``ReshardPlan.expected_collectives`` names the prims the
    recorder emits: the sharded -> replicated plan's expectation holds
    the recorded program clean; a plan that expects another sequence
    (a reduce-scatter: partial -> sharded) is a C5."""
    from horovod_tpu_torch import analysis
    from horovod_tpu_torch.analysis.extract import COLLECTIVE_PRIMS
    from horovod_tpu_torch.parallel.reshard import (
        Layout,
        plan_redistribute,
    )

    spec = programs.build_program("redistribute_to_replicated")
    ok = plan_redistribute((16, 4), "float32", Layout.sharded(16, 4),
                           Layout.replicated(4))
    bad = plan_redistribute((16, 4), "float32", Layout.partial(4),
                            Layout.sharded(16, 4))
    for plan in (ok, bad):
        assert {p for p, _ in plan.expected_collectives()} <= set(
            COLLECTIVE_PRIMS)
    assert analysis.lint(spec.fn, spec.args, axis_env=spec.axis_env,
                         expect_collectives=ok.expected_collectives(
                             "shard")) == []
    diags = analysis.lint(spec.fn, spec.args, axis_env=spec.axis_env,
                          expect_collectives=bad.expected_collectives(
                              "shard"))
    assert [d.id for d in diags] == ["C5"]


def test_fusion_smoke_lint_gate(capsys):
    from horovod_tpu_torch.torch import fusion_smoke

    fusion_smoke._lint_gate()
    assert "FUSION_SMOKE_LINT_OK" in capsys.readouterr().out


def test_unfused_zero_split_step_is_cut_where_jax_cuts_it(monkeypatch):
    """``HOROVOD_JIT_FUSION=0``: the gradient calls and the apply are
    separate programs, so the apply's scatters (its first leads its
    program) are not 'after the backward': C7 quiet, as JAX's split
    ZeRO step is. Without the cuts, the same run fires C7."""
    from horovod_tpu_torch import analysis
    from horovod_tpu_torch.analysis import api
    from horovod_tpu_torch.parallel import fusion
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    monkeypatch.setattr(fusion, "_override", False)
    cfg = programs._config("tiny")
    zero = ZeroConfig(axis="data", size=2, bucket_bytes=1 << 15)
    from horovod_tpu_torch.parallel import precision

    args = programs._split_step(lambda: precision.fused_adam(1e-3), cfg,
                                microbatches=1, zero=zero, mesh_loss=False)
    env = [("data", 2)]
    assert analysis.lint(programs._call, args, axis_env=env,
                         ranks=(0,)) == []
    uncut = extract(programs._call, args, axis_env=env, ranks=(0,), cuts=())
    assert [d.id for d in api.check(uncut, env)] == ["C7"]
