"""Diagnostic objects for hvdlint, the pre-launch collective analyzer.

The port's own copy of ``horovod_tpu/analysis/diagnostics.py``. A
:class:`Diagnostic` is one finding against one program location. The
check ids are stable API (tests assert them, allowlists name them), and
keep the JAX package's numbers:

- **C1** collective divergence: two ranks issue different collective
  sequences on a group they share, or a point-to-point send finds no
  matching receive (the classic SPMD deadlock shape; Horovod catches
  this class at run time in the controller's negotiation, hvdlint before
  launch).
- **C2** group validity: a collective over a process group that is no
  declared mesh axis, or not of the axis's size.
- **C3** width waste: an f32 reduction of an operand upcast from bf16 or
  f16 whose result is consumed at f32 (the wire carries twice the bytes
  the data has). The f32-accumulate round trip (cast up, reduce, cast
  straight back down) is exempt.
- **C5** schedule conformance: the recorded collective sequence against
  the host-built prediction (a pipeline schedule's, the composed-plane
  allreduce's, ZeRO's, a redistribute plan's).
- **C6** shard-collective pairing: a reduce-scatter with no all-gather
  over the same axes after it (the ZeRO apply invariant).
- **C7** collective interleaving: every scatter of a compute-bearing
  program issues after the flop tail, so no compute is left to hide the
  wire time.
- **C8** rank-dependent trip count: ranks issue the same collectives a
  different number of times (a loop whose bound derives from the rank):
  the extra iterations' collectives rendezvous with nothing.

C4 (the donation hazard) has no counterpart: eager PyTorch donates no
buffers, so there is no donation to check.
"""

import dataclasses

ERROR = "error"
WARNING = "warning"

#: check id -> default severity
SEVERITIES = {
    "C1": ERROR,
    "C2": ERROR,
    "C3": WARNING,
    "C5": ERROR,
    "C6": ERROR,
    "C7": ERROR,
    "C8": ERROR,
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One hvdlint finding.

    ``path`` is the program segment the offending collective ran in
    (``"<top>"``, or the step's program a boundary cut off, such as
    ``"_value_and_grad#2"``); ``source`` is the user ``file:line`` that
    issued it, when one was found.
    """

    id: str              # "C1".."C8"
    severity: str        # ERROR or WARNING
    path: str            # program segment
    message: str         # what is wrong
    hint: str = ""       # how to fix it
    source: str = ""     # user file:line (best effort)

    def format(self):
        loc = self.path or "<program>"
        src = f" [{self.source}]" if self.source else ""
        hint = f"\n    hint: {self.hint}" if self.hint else ""
        return f"{self.id} {self.severity}: {loc}{src}: {self.message}{hint}"


def make(check_id, path, message, hint="", source="", severity=None):
    """Build a Diagnostic with the check's default severity."""
    return Diagnostic(
        id=check_id,
        severity=severity or SEVERITIES[check_id],
        path=path,
        message=message,
        hint=hint,
        source=source,
    )


def filter_allowed(diags, allow=()):
    """Drop diagnostics named by ``allow`` (check ids, e.g. ``("C3",)``,
    or exact ``"C3:path"`` pairs)."""
    allow = frozenset(allow)
    return [d for d in diags
            if d.id not in allow and f"{d.id}:{d.path}" not in allow]


def errors(diags):
    """The error-severity subset (what CI gates on)."""
    return [d for d in diags if d.severity == ERROR]
