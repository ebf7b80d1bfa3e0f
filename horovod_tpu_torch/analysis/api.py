"""hvdlint library API (the CLI lives in ``analysis/lint.py``).

::

    from horovod_tpu_torch import analysis
    diags = analysis.lint(step_fn, lambda mesh: (carry, batch),
                          axis_env=[("data", 8)])
    assert not analysis.errors(diags)

The port's counterpart of ``horovod_tpu/analysis/api.py``. The analyzer
runs ``fn`` once for each rank to check, in a ``fake``
``torch.distributed`` world of the mesh's size (``extract.py``): no
card, no peer processes, one CPU process for the whole world.
"""

from horovod_tpu_torch.analysis import checks
from horovod_tpu_torch.analysis import diagnostics as D
from horovod_tpu_torch.analysis.extract import extract


def _axis_env_from_mesh(mesh):
    if mesh is None:
        return []
    return [(str(name), int(size)) for name, size in dict(mesh.shape).items()]


def lint(fn, args=(), kwargs=None, *, mesh=None, axis_env=None,
         expect_collectives=None, allow=(), ranks=None):
    """Analyze one program for SPMD collective consistency.

    ``fn`` is any program the port runs on a mesh (a train step, a
    pipeline schedule, an optimizer apply...). ``args`` is a tuple (the
    same inputs on every rank) or ``args(mesh) -> tuple``, called in each
    rank's fake world with its mesh (build the mesh-bound state, such as
    a ZeRO apply or a pipeline transport, there). ``mesh`` (a port
    ``Mesh``, for its shape) or ``axis_env`` (``[(name, size), ...]``)
    declares the axes; ``ranks`` picks the ranks to run (default: all;
    C1 and C8 compare the ranks run, the other checks read the first).
    ``expect_collectives`` (``parallel.pipeline.predicted_collectives``
    and the like) enables C5; ``allow`` suppresses diagnostics by id
    (``"C3"``) or ``id:path``.

    Returns a list of :class:`~horovod_tpu_torch.analysis.diagnostics.
    Diagnostic`.
    """
    env = list(axis_env) if axis_env is not None \
        else _axis_env_from_mesh(mesh)
    ex = extract(fn, args, kwargs, axis_env=env, ranks=ranks)
    return check(ex, env, expect_collectives=expect_collectives,
                 allow=allow)


def check(ex, axis_env=(), *, expect_collectives=None, allow=()):
    """The checks over an :class:`~horovod_tpu_torch.analysis.extract.
    Extraction` already taken (``extract``) of a program on the mesh
    ``axis_env`` declares: what :func:`lint` returns, for a caller that
    also reads the extraction (its signature, its bytes)."""
    env = list(axis_env)
    declared = [n for n, _ in env]
    ctx = {
        # No declared axes and no collective: no ground truth for C2. No
        # declared axes but collectives: each one is over an undeclared
        # group.
        "mesh_axes": declared if (declared or ex.axis_names_seen) else None,
        "axis_sizes": dict(env),
        "expect_collectives": expect_collectives,
    }
    return D.filter_allowed(checks.run_all(ex, ctx), allow)


def errors(diags):
    """Error-severity subset (what CI gates on)."""
    return D.errors(diags)
