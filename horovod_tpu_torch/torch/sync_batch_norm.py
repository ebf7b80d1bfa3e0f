"""Cross-rank synchronized BatchNorm.

Counterpart of ``horovod_tpu/torch/sync_batch_norm.py``: in training
the batch statistics ``[mean, E[x^2]]`` are averaged over the ranks by
the lane's ``allreduce`` (``sync_bn.<name>.fwd``), and backward
averages the two gradient sums (``sync_bn.<name>.bwd``), so the layer
behaves as if the global batch were on one device. The running
statistics take the unbiased global variance. Every rank holds the same
per-rank batch size, as in the reference. In eval mode, and in a world
of one, it is ``torch.nn.functional.batch_norm`` on the running
statistics (eval) or the local batch, with no collective.
"""

import torch
from torch.nn.modules.batchnorm import _BatchNorm

from horovod_tpu_torch.torch import mpi_ops


class _SyncBatchNormFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, training, name):
        c = x.size(1)
        dims = [0] + list(range(2, x.dim()))
        shape = [1, c] + [1] * (x.dim() - 2)

        if training:
            local_count = x.numel() // c
            mean = x.mean(dims)
            sqmean = (x * x).mean(dims)
            stats = mpi_ops.allreduce(torch.cat([mean, sqmean]),
                                      op=mpi_ops.Average,
                                      name=f"sync_bn.{name}.fwd")
            mean, sqmean = stats[:c], stats[c:]
            var = (sqmean - mean * mean).clamp_(min=0)
            total = local_count * mpi_ops.size()
            if running_mean is not None:
                unbiased = var * total / max(total - 1, 1)
                running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
                running_var.mul_(1 - momentum).add_(unbiased,
                                                    alpha=momentum)
        else:
            mean, var = running_mean, running_var

        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        out = xhat * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.dims = dims
        ctx.shape = shape
        ctx.training = training
        ctx.name = name
        return out

    @staticmethod
    def backward(ctx, dy):
        xhat, weight, invstd = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        c = xhat.size(1)
        n = xhat.numel() // c

        grad_weight = (dy * xhat).sum(dims)
        grad_bias = dy.sum(dims)

        if ctx.training:
            stats = mpi_ops.allreduce(
                torch.cat([grad_bias, grad_weight]) / n,
                op=mpi_ops.Average, name=f"sync_bn.{ctx.name}.bwd")
            mean_dy, mean_dy_xhat = stats[:c], stats[c:]
            dx = (weight * invstd).view(shape) * (
                dy - mean_dy.view(shape) - xhat * mean_dy_xhat.view(shape))
        else:
            dx = (weight * invstd).view(shape) * dy
        return dx, grad_weight, grad_bias, None, None, None, None, None, None


class SyncBatchNorm(_BatchNorm):
    """Drop-in replacement for BatchNorm1d/2d/3d with cross-rank
    statistics; layers are named ``bn0``, ``bn1``... in construction
    order, which must be the same on every rank."""

    _counter = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._name = f"bn{SyncBatchNorm._counter}"
        SyncBatchNorm._counter += 1

    def _check_input_dim(self, x):
        if x.dim() < 2:
            raise ValueError(f"expected at least 2D input, got {x.dim()}D")

    def forward(self, x):
        self._check_input_dim(x)
        training = self.training or not self.track_running_stats
        if not training or mpi_ops.size() == 1:
            return torch.nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, training, self.momentum, self.eps)
        if self.track_running_stats:
            self.num_batches_tracked.add_(1)
        return _SyncBatchNormFn.apply(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            self.eps, self.momentum, training, self._name)
