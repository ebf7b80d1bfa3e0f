"""DistributedOptimizer: data-parallel training with per-parameter
gradient allreduce overlapped with backward.

Counterpart of ``horovod_tpu/torch/optimizer.py:22
_DistributedOptimizer`` and ``:145 DistributedOptimizer``: a hook on each
parameter (``register_post_accumulate_grad_hook``) starts an async
allreduce the moment its gradient is accumulated, after
``backward_passes_per_step`` passes (each pass's gradient then counts
1/N); ``step()`` synchronizes every handle, writes the reduced gradients
back and runs the wrapped optimizer. The class is a runtime subclass of
the wrapped optimizer's class, so ``isinstance`` checks and schedulers
keep working. Hooks are registered only when ``size() > 1``.

Elastic recovery: handles the hooks enqueued before a failed collective
are stale after a reset; the optimizer registers ``_drain_on_reset``
with ``common/elastic.py`` (by weak reference), so the next step starts
clean.
"""

import contextlib
import weakref

import torch

from horovod_tpu_torch.common import basics
from horovod_tpu_torch.common import elastic as _elastic
from horovod_tpu_torch.torch import mpi_ops
from horovod_tpu_torch.torch.compression import Compression


class _DistributedOptimizer(torch.optim.Optimizer):
    def __init__(self, params, named_parameters, compression,
                 backward_passes_per_step, op, process_set_id):
        super(self.__class__, self).__init__(params)
        self._compression = compression
        self._op = op
        self._process_set_id = process_set_id
        self.backward_passes_per_step = backward_passes_per_step
        self._handles = {}       # param -> (Handle, ctx)
        self._allreduce_delay = {}
        self._should_synchronize = True
        self._hook_handles = []

        if named_parameters is not None:
            self._param_names = {p: name for name, p in named_parameters}
        else:
            self._param_names = {
                p: f"param.{gi}.{pi}"
                for gi, group in enumerate(self.param_groups)
                for pi, p in enumerate(group["params"])}

        if mpi_ops.size() > 1:
            self._register_hooks()

    def _register_hooks(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.requires_grad:
                    self._allreduce_delay[p] = self.backward_passes_per_step
                    self._hook_handles.append(
                        p.register_post_accumulate_grad_hook(
                            self._make_hook()))

    def _make_hook(self):
        def hook(p):
            if p not in self._allreduce_delay:
                return
            self._allreduce_delay[p] -= 1
            if self._allreduce_delay[p] == 0:
                self._allreduce_grad_async(p)
        return hook

    def _allreduce_grad_async(self, p):
        name = f"allreduce.{self._param_names.get(p, 'noname')}"
        grad = p.grad
        if self.backward_passes_per_step > 1:
            grad = grad / self.backward_passes_per_step
        compressed, ctx = self._compression.compress(grad.contiguous())
        handle = mpi_ops.allreduce_async(
            compressed, name=name, op=self._op,
            process_set_id=self._process_set_id)
        self._handles[p] = (handle, ctx)

    def _drain_inflight(self):
        """Complete or discard every in-flight handle and reset every
        countdown: the optimizer is clean again."""
        for handle, _ in self._handles.values():
            try:
                handle.synchronize()
            except Exception:  # noqa: BLE001 — poisoned by the failure
                pass
        self._handles.clear()
        for p in self._allreduce_delay:
            self._allreduce_delay[p] = self.backward_passes_per_step

    def synchronize(self):
        """Wait for all outstanding allreduces; write the reduced
        gradients back."""
        # Params whose countdown has not fired (the user stepped early)
        # are reduced now.
        for p, delay in self._allreduce_delay.items():
            if 0 < delay < self.backward_passes_per_step \
                    and p not in self._handles and p.grad is not None:
                self._allreduce_grad_async(p)
        try:
            for p, (handle, ctx) in list(self._handles.items()):
                out = handle.synchronize()
                p.grad.copy_(self._compression.decompress(out, ctx)
                             .view_as(p.grad))
                self._allreduce_delay[p] = self.backward_passes_per_step
        except Exception:
            # One failed collective poisons the rest of the batch: drain
            # them all so the optimizer is reusable, then raise.
            self._drain_inflight()
            raise
        self._handles.clear()

    @contextlib.contextmanager
    def skip_synchronize(self):
        """For the clip-grad pattern: ``synchronize()`` by hand, clip,
        then ``with optimizer.skip_synchronize(): optimizer.step()``."""
        self._should_synchronize = False
        try:
            yield
        finally:
            self._should_synchronize = True

    def step(self, closure=None):
        if self._should_synchronize and mpi_ops.size() > 1:
            self.synchronize()
        return super(self.__class__, self).step(closure)

    def zero_grad(self, *args, **kwargs):
        if self._handles:
            if basics.loop_failed():
                # Left over from a step the lane's failure aborted:
                # stale, not a usage error.
                self._drain_inflight()
            else:
                raise AssertionError(
                    "zero_grad called with allreduces in flight; call "
                    "optimizer.step() or optimizer.synchronize() first")
        return super(self.__class__, self).zero_grad(*args, **kwargs)


def DistributedOptimizer(optimizer, named_parameters=None,
                         compression=Compression.none,
                         backward_passes_per_step=1, op=mpi_ops.Average,
                         process_set_id=0):
    """Wrap a torch optimizer for data-parallel training."""
    cls = type(optimizer.__class__.__name__, (optimizer.__class__,),
               dict(_DistributedOptimizer.__dict__))
    if named_parameters is not None:
        named_parameters = list(named_parameters)
    opt = cls(optimizer.param_groups, named_parameters, compression,
              backward_passes_per_step, op, process_set_id)

    def _drain_on_reset():
        live = ref()
        if live is not None:
            live._drain_inflight()

    # The hook leaves the registry with the optimizer.
    ref = weakref.ref(opt, lambda _r: _elastic.unregister_post_reset_hook(
        _drain_on_reset))
    _elastic.register_post_reset_hook(_drain_on_reset)
    return opt
