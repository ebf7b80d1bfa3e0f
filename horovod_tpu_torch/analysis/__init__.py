"""horovod_tpu_torch.analysis — hvdlint, the pre-launch SPMD analyzer of
the port's programs.

The port's counterpart of ``horovod_tpu/analysis``. Horovod's classic
production failure is silent cross-worker divergence: ranks issuing
different collective sequences and hanging NCCL at scale. Upstream
catches it at run time (the controller's negotiation); hvdlint catches
the class before launch, from one CPU process: it runs a program once
for each rank in a ``fake`` ``torch.distributed`` world, records every
collective and the compute around it (``extract.py``), and runs the
C1-C3, C5-C8 checks over the ranks' sequences (``checks.py``).

Library entry point::

    from horovod_tpu_torch import analysis
    diags = analysis.lint(step_fn, lambda mesh: (carry, batch),
                          axis_env=[("data", 8)])
    assert not analysis.errors(diags)

CLI: ``python -m horovod_tpu_torch.analysis.lint --all``.

:func:`validate_chaos_spec` is the strict ``HOROVOD_FAULT_INJECT``
grammar parse (``analysis/chaos.py``), so CI rejects a malformed chaos
spec that would silently stay disarmed.

Left out of the JAX package's names: ``Loop`` and ``Branches`` (the
jaxpr's control flow; the port keeps one sequence per rank) and C4's
``DonationSite`` (eager PyTorch donates no buffers). hvdcheck
(``horovod_tpu/analysis/model``) is not ported yet.
"""

from horovod_tpu_torch.analysis.diagnostics import (  # noqa: F401
    ERROR,
    SEVERITIES,
    WARNING,
    Diagnostic,
    errors,
    filter_allowed,
)
from horovod_tpu_torch.analysis.chaos import (  # noqa: F401
    ChaosSpecError,
    FaultSpec,
    validate_chaos_spec,
)
from horovod_tpu_torch.analysis.extract import (  # noqa: F401
    Collective,
    Extraction,
    extract,
    linearize,
)


def __getattr__(name):
    # Lazy: ``analysis.lint`` is BOTH the entry-point function and the
    # CLI submodule; resolving it from api.py keeps the attribute a
    # callable and keeps runpy from warning when the CLI runs.
    if name == "lint":
        from horovod_tpu_torch.analysis.api import lint

        globals()["lint"] = lint
        return lint
    raise AttributeError(name)
