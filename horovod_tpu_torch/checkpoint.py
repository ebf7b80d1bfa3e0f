"""Step-numbered checkpoints on disk, for the elastic states.

The port's counterpart of ``horovod_tpu/checkpoint.py:142
CheckpointManager`` (what ``TorchState``/``TreeState(checkpoint_dir=)``
use): ``save(step, state)``, ``latest_step()``, ``restore(step)``,
``max_to_keep`` (3), ``wait``, ``close`` and the context manager. A step
is one ``torch.save`` file, ``<directory>/<step>.pt``, written under a
temporary name and renamed, so a reader never sees half a file. A save
of a step already on disk is skipped (returns False), as orbax skips
it. Only rank 0 of a Horovod job writes (replicas hold the same state);
whether this rank writes is decided at each save, since an elastic
reset renumbers the ranks. Writes are synchronous, so ``wait`` has
nothing to join. Orbax's sharded-array layout, ``encode_pytree`` and the
module-level ``save``/``restore`` wait for ROADMAP.md A11.
"""

import os
import re

import torch

from horovod_tpu_torch.common import basics

_STEP = re.compile(r"(\d+)\.pt\Z")


def _i_write():
    return not basics.is_initialized() or basics.rank() == 0


class CheckpointManager:
    """Checkpoints by step under ``directory``, the newest
    ``max_to_keep`` kept."""

    def __init__(self, directory, max_to_keep=3):
        self._dir = os.path.abspath(os.fspath(directory))
        self._max_to_keep = max_to_keep

    def _path(self, step):
        return os.path.join(self._dir, f"{int(step)}.pt")

    def all_steps(self):
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_STEP.match,
                                                   os.listdir(self._dir))
                      if m)

    def save(self, step, state, wait=False):
        """Write ``state`` (anything ``torch.save`` takes) under
        ``step``. False on a rank that does not write, and when the step
        is already on disk."""
        if not _i_write() or os.path.exists(self._path(step)):
            return False
        os.makedirs(self._dir, exist_ok=True)
        tmp = os.path.join(self._dir, f".{int(step)}.pt.tmp{os.getpid()}")
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        steps = self.all_steps()
        for old in steps[:max(len(steps) - self._max_to_keep, 0)]:
            os.remove(self._path(old))
        return True

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step=None):
        """The state saved under ``step`` (default: the latest), on the
        CPU. Every rank may read."""
        if step is None:
            step = self.latest_step()
        if step is None or not os.path.exists(self._path(step)):
            raise FileNotFoundError(f"no checkpoint for step {step} under "
                                    f"{self._dir}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=False)

    def wait(self):
        """Writes are synchronous: nothing to wait for."""

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
