"""ResNet v1.5 (depths 18-152), functional, in plain PyTorch.

The port of ``horovod_tpu/models/resnet.py`` (``ResNetConfig``,
``resnet_init``, ``resnet_forward``, ``resnet_loss``): the same keys,
list structure and HWIO conv shapes, so ``models.convert.from_jax_params``
moves JAX's params and batch-norm state across unchanged. The JAX
package computes the convolutions with ``lax.conv_general_dilated``
outside any Pallas kernel, so here they are ``F.conv2d`` (cuDNN on the
card); no kernel of the port runs on this path.

- Activations are NHWC at the public functions, as in JAX; inside they
  are NCHW views of NHWC memory (torch's ``channels_last``), so the
  convolutions run in that layout.
- "SAME" padding is JAX's rule, ``total = max((ceil(n/s)-1)*s + k - n,
  0)``, ``low = total // 2``: asymmetric at stride 2 (the stem's 7x7/2
  at 224 pads (2, 3), a 3x3/2 at 56 and the max-pool (0, 1), the pool
  with -inf), so it is padded explicitly where the two sides differ.
- Batch norm in f32: the batch's population variance (two passes, as
  ``jnp.var``) for the output and for the running update ``new = 0.9 *
  old + 0.1 * batch``; the output cast back to the compute dtype.
- Under a mesh (``parallel.mesh.Mesh``, any axes), every leaf is
  replicated (``resnet_partition_rules``: JAX's ``P()`` for all) and the
  batch is split over ``data`` and ``fsdp`` (JAX's ``P(("data",
  "fsdp"))``, ``mesh.shard(x, seq_dim=None)``); ranks along the other
  axes repeat the same work, as under GSPMD. Each rank's batch
  statistics are the global batch's: the mean, then the centred second
  moment, each summed by ``parallel.ops.psum`` over the batch group; a
  global statistic enters the rank's own work through
  ``parallel.ops.replicate`` (whose backward sums its cotangent over the
  group, the transpose of JAX's invariant-to-varying cast), as every
  parameter leaf does. The loss is the global batch's mean, the same on
  every rank. This is what JAX's GSPMD step over a data-sharded batch
  computes (``__graft_entry__.py:513 _resnet_dp_step``).
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F

from horovod_tpu_torch._device import check_on, resolve_device
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten
from horovod_tpu_torch.parallel.mesh import ROW_AXES
from horovod_tpu_torch.parallel.ops import psum, replicate
from horovod_tpu_torch.parallel.sharding import P

# depths per stage for each family member, and whether it is bottlenecked
_DEPTHS = {
    18: ((2, 2, 2, 2), False),
    34: ((3, 4, 6, 3), False),
    50: ((3, 4, 6, 3), True),
    101: ((3, 4, 23, 3), True),
    152: ((3, 8, 36, 3), True),
}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 50
    num_classes: int = 1000
    width: int = 64
    compute_dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @property
    def stage_depths(self):
        return _DEPTHS[self.depth][0]

    @property
    def bottleneck(self):
        return _DEPTHS[self.depth][1]

    @property
    def dtype(self):
        return getattr(torch, self.compute_dtype)


def resnet_init(config, generator, device=None):
    """Returns ``(params, state)``, ``state`` the batch-norm running
    statistics, with JAX's keys and shapes (f32; the values differ:
    torch and JAX draw different streams from one seed). Normals are
    drawn on ``generator``'s device and moved to ``device`` (default
    cuda)."""
    c = config
    dev = resolve_device(device)

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(std).to(dev)

    def conv(kh, kw, cin, cout):
        return normal((kh, kw, cin, cout), (2.0 / (kh * kw * cin)) ** 0.5)

    def vec(value, n):
        return torch.full((n,), float(value), dtype=torch.float32,
                          device=dev)

    def bn(n):
        return {"scale": vec(1, n), "bias": vec(0, n)}

    def bn_state(n):
        return {"mean": vec(0, n), "var": vec(1, n)}

    params = {"stem": {"conv": conv(7, 7, 3, c.width), "bn": bn(c.width)}}
    state = {"stem": {"bn": bn_state(c.width)}}
    cin = c.width
    expansion = 4 if c.bottleneck else 1
    for s, depth in enumerate(c.stage_depths):
        cmid = c.width * (2 ** s)
        cout = cmid * expansion
        blocks_p, blocks_s = [], []
        for b in range(depth):
            stride = 2 if (s > 0 and b == 0) else 1
            bp, bs = {}, {}
            if c.bottleneck:
                bp["conv1"] = conv(1, 1, cin, cmid)
                bp["conv2"] = conv(3, 3, cmid, cmid)
                bp["conv3"] = conv(1, 1, cmid, cout)
                last = "bn3"
                chans = (("1", cmid), ("2", cmid), ("3", cout))
            else:
                bp["conv1"] = conv(3, 3, cin, cmid)
                bp["conv2"] = conv(3, 3, cmid, cout)
                last = "bn2"
                chans = (("1", cmid), ("2", cout))
            for i, ch in chans:
                bp[f"bn{i}"] = bn(ch)
                bs[f"bn{i}"] = bn_state(ch)
            # The block's last BN scale starts at zero: each residual
            # block starts as the identity.
            bp[last]["scale"] = vec(0, cout)
            if cin != cout or stride != 1:
                bp["proj"] = conv(1, 1, cin, cout)
                bp["proj_bn"] = bn(cout)
                bs["proj_bn"] = bn_state(cout)
            blocks_p.append(bp)
            blocks_s.append(bs)
            cin = cout
        params[f"stage{s}"] = blocks_p
        state[f"stage{s}"] = blocks_s
    params["head"] = {"w": normal((cin, c.num_classes), cin ** -0.5),
                      "b": vec(0, c.num_classes)}
    return params, state


def _same_pads(n, k, stride):
    """JAX's "SAME" padding of one dimension: (low, high)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    """``x`` (NCHW view) for a "SAME" window: ``(x, (h, w))`` with the
    symmetric padding left to the op, or padded here (``value``) and
    ``(0, 0)`` when the two sides differ."""
    hl, hh = _same_pads(x.shape[2], kh, stride)
    wl, wh = _same_pads(x.shape[3], kw, stride)
    if hl == hh and wl == wh:
        return x, (hl, wl)
    x = F.pad(x, (wl, wh, hl, hh), value=value)
    return x.contiguous(memory_format=torch.channels_last), (0, 0)


def _conv(x, w, stride=1, dtype=torch.bfloat16):
    """A "SAME" convolution of the NCHW view ``x`` by the HWIO ``w``, in
    ``dtype``."""
    kh, kw = w.shape[0], w.shape[1]
    wt = w.to(dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x, pad = _pad_same(x.to(dtype), kh, kw, stride)
    return F.conv2d(x, wt, stride=stride, padding=pad)


def _global_mean(t, count, group):
    """The mean over (N, H, W) of the NCHW view ``t`` across ``group``'s
    shards (``count`` elements a channel in all), entering this rank's
    work through ``replicate``."""
    total = psum(t.sum(dim=(0, 2, 3)), group) / count
    return replicate([total], group)[0]


def _batch_norm(x, p, s, train, momentum, eps, group=None, n_ranks=1):
    """Returns (y, new running stats) for the NCHW view ``x``; statistics
    in f32, over the global batch of ``n_ranks`` equal shards under
    ``group`` (the batch axes', or None)."""
    xf = x.float()
    if train:
        count = x.numel() // x.shape[1] * n_ranks
        mean = _global_mean(xf, count, group)
        centred = xf - mean[None, :, None, None]
        var = _global_mean(centred * centred, count, group)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) *
                 mean.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        centred = xf - mean[None, :, None, None]
        new_s = s
    scale = torch.rsqrt(var + eps) * p["scale"]
    y = centred * scale[None, :, None, None] + p["bias"][None, :, None, None]
    return y.to(x.dtype), new_s


def resnet_partition_rules():
    """Data-parallel: every leaf replicated, as the JAX package's."""
    return [(r".*", P())]


def _batch_axis(mesh):
    """The group and size of ``mesh``'s batch axes, ``data`` and
    ``fsdp`` (None, 1 without a mesh)."""
    if mesh is None:
        return None, 1
    return mesh.batch_group(ROW_AXES), mesh.axes_size(ROW_AXES)


def resnet_forward(params, state, x, config, train=True, mesh=None,
                   device=None):
    """x [N, H, W, 3] float -> (logits [N, classes] f32, new_state).

    ``device`` follows the entry-point rule (None means cuda, or the
    mesh's device); the params must lie there. Under ``mesh`` ``x`` is
    this rank's shard of the batch (``mesh.shard(x, seq_dim=None)``),
    the batch-norm statistics are the global batch's, and each
    parameter's gradient is summed over the batch axes."""
    c = config
    dev = resolve_device(mesh.device if device is None and mesh is not None
                         else device)
    check_on(dev, head=params["head"]["w"])
    group, n_ranks = _batch_axis(mesh)
    if mesh is not None:
        params = tree_unflatten(params, replicate(
            tree_leaves(params), mesh.grad_group(batch_axes=ROW_AXES)))
    dt = c.dtype
    bn = functools.partial(_batch_norm, train=train, momentum=c.bn_momentum,
                           eps=c.bn_eps, group=group, n_ranks=n_ranks)
    x = torch.as_tensor(x, device=dev).permute(0, 3, 1, 2)   # NHWC memory
    new_state = {"stem": {}}
    h = _conv(x.to(dt), params["stem"]["conv"], stride=2, dtype=dt)
    h, new_state["stem"]["bn"] = bn(h, params["stem"]["bn"],
                                    state["stem"]["bn"])
    h = F.relu(h)
    h, pad = _pad_same(h, 3, 3, 2, value=float("-inf"))
    h = F.max_pool2d(h, 3, 2, padding=pad)
    for s in range(len(c.stage_depths)):
        stage_state = []
        for b, bp in enumerate(params[f"stage{s}"]):
            bs = state[f"stage{s}"][b]
            nbs = {}
            stride = 2 if (s > 0 and b == 0) else 1
            shortcut = h
            if "proj" in bp:
                shortcut = _conv(h, bp["proj"], stride=stride, dtype=dt)
                shortcut, nbs["proj_bn"] = bn(shortcut, bp["proj_bn"],
                                              bs["proj_bn"])
            if c.bottleneck:
                y = _conv(h, bp["conv1"], dtype=dt)
                y, nbs["bn1"] = bn(y, bp["bn1"], bs["bn1"])
                y = F.relu(y)
                y = _conv(y, bp["conv2"], stride=stride, dtype=dt)  # v1.5
                y, nbs["bn2"] = bn(y, bp["bn2"], bs["bn2"])
                y = F.relu(y)
                y = _conv(y, bp["conv3"], dtype=dt)
                y, nbs["bn3"] = bn(y, bp["bn3"], bs["bn3"])
            else:
                y = _conv(h, bp["conv1"], stride=stride, dtype=dt)
                y, nbs["bn1"] = bn(y, bp["bn1"], bs["bn1"])
                y = F.relu(y)
                y = _conv(y, bp["conv2"], dtype=dt)
                y, nbs["bn2"] = bn(y, bp["bn2"], bs["bn2"])
            h = F.relu(y + shortcut)
            stage_state.append(nbs)
        new_state[f"stage{s}"] = stage_state
    pooled = h.float().mean(dim=(2, 3))
    logits = pooled @ params["head"]["w"] + params["head"]["b"]
    return logits, new_state


def resnet_loss(params, state, batch, config, train=True, mesh=None,
                device=None):
    """Softmax cross-entropy; batch = {"images": [N, H, W, 3], "labels":
    [N]}. Returns ``(loss, new_state)``. Under ``mesh`` the batch is this
    rank's shard and the loss is the global batch's mean, the same on
    every rank."""
    logits, new_state = resnet_forward(params, state, batch["images"],
                                       config, train=train, mesh=mesh,
                                       device=device)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[:, None])
    if mesh is None:
        return nll.mean(), new_state
    group, n_ranks = _batch_axis(mesh)
    return psum(nll.sum(), group) / (nll.numel() * n_ranks), new_state
