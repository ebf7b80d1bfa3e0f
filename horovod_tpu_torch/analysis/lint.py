"""hvdlint CLI: ``python -m horovod_tpu_torch.analysis.lint``.

::

    python -m horovod_tpu_torch.analysis.lint --all
    python -m horovod_tpu_torch.analysis.lint --program pipeline_gpipe
    python -m horovod_tpu_torch.analysis.lint --program llama_train_step \
        --config tiny_moe
    python -m horovod_tpu_torch.analysis.lint --all --allow C3

The port's copy of ``horovod_tpu/analysis/lint.py``. Exit status 1 when
any error-severity diagnostic survives the allowlist. The library API is
``horovod_tpu_torch.analysis.lint(fn, args, axis_env=...)``
(``analysis/api.py``; this module is the CLI shim so the two share the
dotted name).
"""

import argparse
import sys
import types

from horovod_tpu_torch.analysis.api import errors, lint  # noqa: F401


class _CallableModule(types.ModuleType):
    """Importing this submodule rebinds the package attribute
    ``horovod_tpu_torch.analysis.lint`` from the API function to the
    module; a callable module keeps ``analysis.lint(fn, args, ...)``
    working either way."""

    def __call__(self, *args, **kwargs):
        return lint(*args, **kwargs)


sys.modules[__name__].__class__ = _CallableModule


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.analysis.lint",
        description="hvdlint: pre-launch SPMD collective-consistency "
                    "analyzer of the port's programs (checks C1-C3, "
                    "C5-C8)")
    p.add_argument("--program", action="append", default=[],
                   help="registered program name (repeatable); see "
                        "--list")
    p.add_argument("--all", action="store_true",
                   help="lint every registered shipped program "
                        "(default when no --program is given)")
    p.add_argument("--list", action="store_true",
                   help="list registered programs and exit")
    p.add_argument("--config", default="tiny",
                   help="model config preset for model-backed programs "
                        "(tiny, tiny_moe; default tiny)")
    p.add_argument("--allow", action="append", default=[],
                   help="suppress a diagnostic id (e.g. C3) or id:path")
    args = p.parse_args(argv)

    from horovod_tpu_torch.analysis import programs

    if args.list:
        for name in programs.program_names():
            print(name)
        return 0
    names = list(args.program)
    if args.all or not names:
        names = programs.program_names()

    rc = 0
    for name in names:
        diags = programs.lint_program(name, config=args.config,
                                      allow=tuple(args.allow))
        status = "clean" if not diags else f"{len(diags)} diagnostic(s)"
        print(f"[hvdlint] {name}: {status}")
        for d in diags:
            print("  " + d.format())
        if errors(diags):
            rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
