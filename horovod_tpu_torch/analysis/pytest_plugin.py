"""Pytest fixtures for hvdlint (the port's copy of
``horovod_tpu/analysis/pytest_plugin.py``).

A test file imports them (``from horovod_tpu_torch.analysis.pytest_plugin
import hvdlint, hvdlint_shipped``):

- ``hvdlint`` — assert one program is collective-consistent::

      def test_my_step(hvdlint):
          diags = hvdlint(step_fn, lambda mesh: (carry, batch),
                          axis_env=[("data", 2)])

  Fails the test on any error-severity diagnostic; returns the full list
  so tests can also assert on warnings.
- ``hvdlint_shipped`` — lints one named program of
  ``analysis.programs`` and asserts it clean.
"""

import pytest


@pytest.fixture()
def hvdlint():
    from horovod_tpu_torch.analysis.api import errors, lint

    def check(fn, args=(), allow=(), **kw):
        diags = lint(fn, args, allow=allow, **kw)
        errs = errors(diags)
        if errs:
            pytest.fail(
                "hvdlint found collective-consistency errors:\n"
                + "\n".join(d.format() for d in errs))
        return diags

    return check


@pytest.fixture()
def hvdlint_shipped():
    from horovod_tpu_torch.analysis import programs

    def check(name, config="tiny", allow=()):
        diags = programs.lint_program(name, config=config, allow=allow)
        if diags:
            pytest.fail(
                f"hvdlint: shipped program {name!r} is not clean:\n"
                + "\n".join(d.format() for d in diags))
        return diags

    return check
