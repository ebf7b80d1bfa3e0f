"""The port's public surface against the JAX package's.

- The capability probes of the torch frontend (``hvd.gloo_built()``,
  ``hvd.nccl_built()``...), beside ``tests/single/test_basics.py:117
  test_capability_api``: the twelve names exist, each answers what
  ``horovodrun-torch --check-build`` decides (``common/capabilities.py
  probe``), and they differ from the reference's only where the port's
  reality does: NCCL and CUDA (torch's, on a machine with a card), MPI
  (the bare-mpirun start needs mpi4py) and XLA (the port has no XLA
  plane).
- The Prometheus text: the same snapshot gives the reference's
  ``_flatten_prom`` and the port's the same ``hvdtpu_wire_*`` byte
  counters and compression ratios and the same ``hvdtpu_serving_*``
  gauges.
- The package-level names: every public name of the JAX package's
  ``models``, ``parallel``, ``serving``, ``runner.elastic`` and
  ``analysis`` (and of each hvdlint module) that the port has a
  counterpart for is a name of the port's module of the same path;
  ``LEFT_OUT`` records the rest and why, and the lint entry point's
  keywords are the reference's, less C4's ``donate_argnums``.
"""

import importlib
import inspect
import re

import pytest

CAPABILITIES = ("gloo_built", "gloo_enabled", "mpi_built", "mpi_enabled",
                "mpi_threads_supported", "nccl_built", "cuda_built",
                "rocm_built", "ccl_built", "ddl_built", "xla_built",
                "xla_enabled")


def test_capability_probes_answer_the_check_build(monkeypatch):
    import torch

    import horovod_tpu.torch as ref
    import horovod_tpu_torch.torch as hvd
    from horovod_tpu_torch.common import capabilities
    from horovod_tpu_torch.runner import launch

    for var in ("OMPI_COMM_WORLD_RANK", "PMIX_RANK", "PMI_RANK",
                "SLURM_PROCID", "JSM_NAMESPACE_RANK"):
        monkeypatch.delenv(var, raising=False)
    got = {n: getattr(hvd, n)() for n in CAPABILITIES}
    assert all(isinstance(v, bool) for v in got.values())
    caps = capabilities.probe()
    rows = {label.split()[0]: ok for _, section in launch.check_build_rows()
            for ok, label in section}
    assert got["gloo_built"] and got["gloo_enabled"] and rows["gloo"]
    assert got["nccl_built"] == rows["NCCL"] == caps["nccl"]
    assert got["cuda_built"] == rows["CUDA"] == torch.cuda.is_available()
    assert got["mpi_built"] == caps["mpi4py"] == rows["MPI"]
    assert got["mpi_threads_supported"]
    assert not any(got[n] for n in ("rocm_built", "ccl_built", "ddl_built",
                                    "xla_built", "xla_enabled"))
    assert not got["mpi_enabled"]
    monkeypatch.setenv("OMPI_COMM_WORLD_RANK", "0")
    assert hvd.mpi_enabled() and ref.mpi_enabled()
    monkeypatch.delenv("OMPI_COMM_WORLD_RANK")
    want = {n: getattr(ref, n)() for n in CAPABILITIES}
    differ = {n for n in CAPABILITIES if got[n] != want[n]}
    assert differ <= {"nccl_built", "cuda_built", "mpi_built", "xla_built",
                      "xla_enabled"}, (got, want)


def _snapshot():
    return {
        "ops": {"allreduce": {"responses": 3, "tensors": 5, "bytes": 640}},
        "wire": {"tx_bytes": 1200, "rx_bytes": 1100,
                 "tx_logical_bytes": 2400, "rx_logical_bytes": 2200,
                 "cross_tx_bytes": 300, "cross_rx_bytes": 280,
                 "cross_tx_logical_bytes": 600,
                 "cross_rx_logical_bytes": 560,
                 "compression_ratio": 2.0,
                 "cross_compression_ratio": 2.0},
        "elastic": {"epoch": 1},
    }


_COPIED = re.compile(r"hvdtpu_(wire_\w*(_bytes_total|compression_ratio)|"
                     r"serving_\w+)\{")


def test_prometheus_wire_and_serving_lines_match_the_reference():
    from horovod_tpu.telemetry.exporters import _flatten_prom as ref_prom

    from horovod_tpu_torch.telemetry.exporters import _flatten_prom

    def copied(text):
        return sorted(line for line in text.splitlines()
                      if _COPIED.match(line))

    snap = _snapshot()
    port, ref = copied(_flatten_prom(snap, 2)), copied(ref_prom(snap, 2))
    assert port == ref
    assert 'hvdtpu_wire_tx_bytes_total{rank="2"} 1200' in port
    assert 'hvdtpu_wire_cross_compression_ratio{rank="2"} 2.0' in port
    assert sum(line.startswith("hvdtpu_serving_") for line in port) == 10
    assert sum(line.startswith("hvdtpu_wire_") for line in port) == 10


# Names of the JAX package's package-level surface the port leaves out:
# JAX-only per ROADMAP.md "Not queued" (they act on jax.sharding objects
# or jax.local_devices), collectives the port's models never needed and
# so never got, and what hvdlint's recording by execution has no use
# for.
LEFT_OUT = {
    "models": set(),
    "parallel": {
        "local_mesh", "named_sharding", "with_constraint",
        "layout_from_sharding",                    # Not queued: JAX-only
        "pmean", "pbroadcast",                     # no port counterpart
    },
    "serving": set(),
    "runner.elastic": set(),
    # A12b's fleet observatory, SLO engine and autoscaler are modules
    # (telemetry/{fleet,slo,autoscale}.py), not package-level names.
    "telemetry": set(),
    # The jaxpr's control-flow nodes: the port records one sequence per
    # rank, so a loop or a branch is the ranks' sequences differing.
    "analysis": {"Loop", "Branches"},
    "analysis.extract": {
        "Loop", "Branches",
        "DonationSite",   # C4: eager PyTorch donates no buffers
        "build_profile",  # the profile is taken while the program runs
    },
    "analysis.checks": {"check_donation_hazards",    # C4, as above
                        "Loop", "Branches", "Collective"},   # imports
    "analysis.api": set(),
    "analysis.diagnostics": set(),
    "analysis.chaos": set(),
    "analysis.programs": set(),
}

# The lint entry point's keywords the port leaves out, and why.
LINT_LEFT_OUT = {
    "donate_argnums": "C4: eager PyTorch donates no buffers, so there is "
                      "no donation to check",
}


def _public(module):
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


@pytest.mark.parametrize("pkg", sorted(LEFT_OUT))
def test_package_level_names_match_the_jax_package(pkg):
    ref = importlib.import_module(f"horovod_tpu.{pkg}")
    port = importlib.import_module(f"horovod_tpu_torch.{pkg}")
    want = _public(ref) - LEFT_OUT[pkg]
    assert want - set(dir(port)) == set()
    assert LEFT_OUT[pkg] & set(dir(port)) == set()


def test_lint_keywords_match_the_jax_package():
    from horovod_tpu.analysis.api import lint as ref_lint

    from horovod_tpu_torch.analysis.api import lint

    ref = set(inspect.signature(ref_lint).parameters) - set(LINT_LEFT_OUT)
    port = set(inspect.signature(lint).parameters)
    assert ref <= port
    assert not set(LINT_LEFT_OUT) & port


def test_c8_imports():
    from horovod_tpu_torch.models import LlamaConfig, llama_loss
    from horovod_tpu_torch.parallel import (
        ZeroConfig,
        fused_adam,
        make_split_train_step,
        master_weights,
    )
    from horovod_tpu_torch.runner.elastic import ElasticDriver
    from horovod_tpu_torch.serving import DecodeEngine, ServingLoop

    assert all(callable(x) for x in (LlamaConfig, llama_loss, ZeroConfig,
                                     fused_adam, make_split_train_step,
                                     master_weights, ElasticDriver,
                                     DecodeEngine, ServingLoop))
