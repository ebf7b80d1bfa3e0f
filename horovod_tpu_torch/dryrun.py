"""The port's multi-rank dryrun: ``python -m horovod_tpu_torch.dryrun 8``.

Counterpart of ``__graft_entry__.py:389 dryrun_multichip``. It spawns
``n`` ranks, one process a rank as the port runs a mesh: on the cards
(one a rank, NCCL) when ``n`` CUDA cards are visible, else on the CPU
(gloo), as the reference runs on its own devices when it has enough and
on emulated CPU devices when it has not; the first line it prints says
which. It runs every pass of the reference's dryrun, in its order, at
its tiny shapes (head_dim 16, the smallest the attention kernels take),
each held against the port's **unsharded** step on the same params and
batch with the reference's tolerances:

- ``dense/dp.fsdp.tp.sp`` and ``dense/ulysses-sp``: the dense Llama under
  ``seq`` x ``tensor`` x ``fsdp`` (ring, then Ulysses attention), one
  step of ``fused_adam``; the loss to 1e-4 and the gradients' global
  norm to 1e-3 of the unsharded ones;
- ``dense/split-accum2``: the split step with 2 microbatches on the mesh
  against one gradient call of the unsharded model, SGD (lr 0.1): the
  loss to 1e-5, every updated param to rtol 1e-4, atol 1e-6;
- ``dense/zero1``: ZeRO-1 over a real ``data`` axis of ``data=2 x fsdp=2
  x tensor=2`` (the reference emulates ``ZeroConfig(axis="data",
  size=4)`` on a ``data=1`` mesh; the port's ranks are real) against the
  replicated ``fused_adam`` split step on the same mesh: loss 1e-5,
  params rtol 1e-4, atol 1e-6; loss and gradient norm as above;
- ``dense/hier``: ``hier_allreduce`` (intra ``tensor``, inter ``fsdp``)
  of the unsharded gradients against ``psum`` over both axes (the same
  bits on replicated operands, rtol 1e-6 on rank-varying ones), and the
  ZeRO apply split across two planes of four ranks against one plane of
  eight on the same gradients: rtol 1e-5, atol 1e-7;
- ``moe/ep.tp.fsdp``: the GShard MoE under ``expert`` x ``tensor`` x
  ``fsdp``, as the dense pass;
- ``pp/pipe.tp.fsdp``, ``pp-1f1b/pipe.tp.fsdp`` and
  ``pp-interleaved-v2/pipe.tp.fsdp``: the dense Llama at two layers a
  stage under ``pipe=2`` x ``tensor`` x ``fsdp`` through gpipe, 1F1B and
  the interleaved schedule (V=2, one layer a chunk; 4 microbatches when
  the reference's batch of ``2 x data x fsdp`` rows divides by 4, else
  2), as the dense pass. Each microbatch's rows split evenly over the
  batch ranks, so the interleaved pass takes that many rows a batch
  rank;
- ``resnet/dp.sync-bn``: ResNet-18 (width 8) over ``data=n``, its batch
  norm over the whole batch; ``bert/mlm.tp.fsdp``: BERT under ``tensor``
  x ``fsdp`` x ``data``: the loss to 1e-4 and the gradient norm to 1e-3.

Exit status 0 when every pass matches. The passes hold
the port against itself; ``tests/test_torch_mesh_parallel.py`` holds the
same sharded models against the JAX package's.
"""

import dataclasses
import math
import multiprocessing as mp
import os
import socket
import sys
import traceback

PIPELINE_PASSES = ("pp/pipe.tp.fsdp", "pp-1f1b/pipe.tp.fsdp",
                   "pp-interleaved-v2/pipe.tp.fsdp")
_TIMEOUT_S = 600


def _mesh_axes_for(n_devices, axes=("seq", "tensor", "fsdp"), fixed=None):
    """Split n devices: any ``fixed`` sizes first, then 2 onto each axis
    in ``axes`` while divisible, the remainder onto data (the
    reference's ``__graft_entry__.py:50``). Raises if every requested
    axis would collapse to 1, which would make the dryrun vacuous."""
    sizes = dict(fixed or {})
    remaining = n_devices
    for v in sizes.values():
        if remaining % v:
            raise ValueError(f"_mesh_axes_for: fixed axes {fixed} do not "
                             f"divide n_devices={n_devices}")
        remaining //= v
    for axis in axes:
        if remaining % 2 == 0:
            sizes[axis] = 2
            remaining //= 2
        else:
            sizes[axis] = 1
    sizes["data"] = remaining
    collapsed = [a for a in axes if sizes[a] == 1]
    fixed_parallel = any(v > 1 for v in (fixed or {}).values())
    if n_devices > 1 and len(collapsed) == len(axes) and not fixed_parallel:
        raise ValueError(
            f"_mesh_axes_for: n_devices={n_devices} left every requested "
            f"parallelism axis {axes} at size 1: use a multiple of 2")
    return sizes


# ---- the passes (each runs on every rank) ----------------------------------


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _close(got, want, rel, what, label):
    _check(abs(got - want) < rel * max(1.0, abs(want)),
           f"{label} {what} {got} != unsharded {want}")


def _grad_norm(grads):
    import torch

    from horovod_tpu_torch.parallel._tree import tree_leaves

    return math.sqrt(sum(float(torch.sum(g.double() ** 2))
                         for g in tree_leaves(grads)))


def _value_and_grad(loss_fn, params):
    import torch

    from horovod_tpu_torch.parallel._tree import (
        tree_leaves,
        tree_map,
        tree_unflatten,
    )

    live = tree_map(lambda p: p.detach().clone().requires_grad_(True),
                    params)
    loss = loss_fn(live)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss.detach()), tree_unflatten(live, list(grads))


def _llama_cfg(sizes, moe=False, **kw):
    from horovod_tpu_torch.models.llama import LlamaConfig

    heads = 2 * sizes["tensor"]
    common = dict(d_model=16 * heads, n_heads=heads, n_kv_heads=heads,
                  n_layers=2, d_ff=16 * sizes["tensor"], vocab_size=64,
                  dtype="float32", remat="none")
    common.update(kw)
    if moe:
        return LlamaConfig.tiny_moe(n_experts=2 * sizes["expert"],
                                    moe_impl="gshard", **common)
    return LlamaConfig.tiny(**common)


def _to(tree, device):
    from horovod_tpu_torch.parallel._tree import tree_map

    return tree_map(lambda x: x.to(device), tree)


def _llama_setup(cfg, sizes, seq, seed, device, rows=2):
    """Seeded params and batch of ``rows`` rows a batch rank (drawn on
    the CPU, moved to ``device``)."""
    import torch

    from horovod_tpu_torch.models.llama import llama_init

    params = llama_init(cfg, torch.Generator().manual_seed(seed),
                        device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab_size,
                           (rows * sizes["data"] * sizes["fsdp"], seq),
                           generator=g, dtype=torch.int32)
    return _to(params, device), _to(
        {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}, device)


def _mesh(sizes, device):
    from horovod_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(device=device, **sizes)


def _virtual(cfg, mesh):
    """The chunks a stage holds in the device-major layer order (1: the
    canonical order serves)."""
    if mesh.shape["pipe"] > 1 and cfg.pipeline_schedule == \
            "interleaved_1f1b":
        return cfg.pipeline_virtual_stages
    return 1


def _llama_blocks(params, mesh, cfg):
    """This rank's blocks (the layers split over ``pipe`` when the mesh
    has the axis, in the interleaved schedule's device-major order)."""
    from horovod_tpu_torch.models.llama import llama_partition_rules
    from horovod_tpu_torch.parallel.sharding import shard_params

    return shard_params(params, mesh, llama_partition_rules(
        mesh.shape["pipe"] > 1, _virtual(cfg, mesh)))


def _unsharded(cfg, params, batch, device):
    from horovod_tpu_torch.models.llama import llama_loss

    return _value_and_grad(lambda p: llama_loss(p, batch, cfg,
                                                device=device), params)


def _train_one_step(cfg, sizes, seq, seed, label, device, rows=2):
    """The sharded value and gradient and one ``fused_adam`` apply on the
    blocks: loss and gradient norm against the unsharded model's."""
    import torch

    from horovod_tpu_torch.models.llama import llama_loss
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.sharding import gather_params

    mesh = _mesh(sizes, device)
    params, batch = _llama_setup(cfg, sizes, seq, seed, device, rows)
    ref_loss, ref_grads = _unsharded(cfg, params, batch, device)
    blocks, specs = _llama_blocks(params, mesh, cfg)
    local = mesh.shard_batch(batch)
    loss, grads = _value_and_grad(
        lambda p: llama_loss(p, local, cfg, mesh=mesh), blocks)
    opt = precision.fused_adam(1e-3)
    new, _ = opt.apply(blocks, grads, opt.init(blocks))
    _check(all(bool(torch.isfinite(p).all()) for p in tree_leaves(new)),
           f"non-finite {label} params")
    gn = _grad_norm(gather_params(grads, mesh, specs))
    _close(loss, ref_loss, 1e-4, "loss", label)
    _close(gn, _grad_norm(ref_grads), 1e-3, "grad norm", label)
    return (f"dryrun_multichip[{label}]: mesh={_shape(mesh)} "
            f"loss={loss:.4f} grad_norm={gn:.4f} ok (matches unsharded)")


def _shape(mesh):
    return {a: n for a, n in mesh.shape.items() if n > 1 or a == "data"}


def _sgd(lr):
    """Plain SGD as a fused optimizer of the split step."""
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.parallel._tree import tree_map

    return precision.FusedOptimizer(
        init=lambda params: (),
        apply=lambda params, grads, state: (
            tree_map(lambda p, g: p - lr * g, params, grads), state))


def _params_close(got, want, rtol, atol, label):
    import numpy as np

    from horovod_tpu_torch.parallel._tree import tree_leaves

    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.detach().cpu().numpy(),
                                   b.detach().cpu().numpy(),
                                   rtol=rtol, atol=atol, err_msg=label)


def _split_step_pass(cfg, sizes, seq, seed, device,
                     label="dense/split-accum2"):
    """The split step with 2 microbatches on the mesh against one
    unsharded gradient call, both SGD: loss and updated params."""
    from horovod_tpu_torch.models.llama import llama_loss
    from horovod_tpu_torch.parallel import train_step
    from horovod_tpu_torch.parallel._tree import tree_map
    from horovod_tpu_torch.parallel.sharding import gather_params

    mesh = _mesh(sizes, device)
    params, batch = _llama_setup(cfg, sizes, seq, seed, device)
    ref_loss, ref_grads = _unsharded(cfg, params, batch, device)
    ref_params = tree_map(lambda p, g: p - 0.1 * g, params, ref_grads)
    blocks, specs = _llama_blocks(params, mesh, cfg)
    ts = train_step.make_split_train_step(
        lambda p, d: llama_loss(p, d, cfg, mesh=mesh), _sgd(0.1),
        microbatches=2)
    loss, (new, _) = ts.step(ts.init(blocks), mesh.shard_batch(batch))
    loss = float(loss)
    _close(loss, ref_loss, 1e-5, "loss", label)
    _params_close(gather_params(new, mesh, specs), ref_params, 1e-4, 1e-6,
                  label)
    return (f"dryrun_multichip[{label}]: mesh={_shape(mesh)} "
            f"loss={loss:.4f} ok (matches unsharded)")


def _zero1_pass(cfg, seq, seed, device, label="dense/zero1"):
    """ZeRO-1 over a real ``data`` axis of ``data=2 x fsdp=2 x
    tensor=2``: loss and gradient norm against the unsharded model,
    updated params against the replicated fused-Adam split step."""
    from horovod_tpu_torch.models.llama import llama_loss
    from horovod_tpu_torch.parallel import precision, train_step
    from horovod_tpu_torch.parallel._tree import tree_map
    from horovod_tpu_torch.parallel.sharding import gather_params
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    sizes = dict(data=2, fsdp=2, tensor=2)
    mesh = _mesh(sizes, device)
    params, batch = _llama_setup(cfg, sizes, seq, seed, device)
    ref_loss, ref_grads = _unsharded(cfg, params, batch, device)
    blocks, specs = _llama_blocks(params, mesh, cfg)
    local = mesh.shard_batch(batch)

    def loss_fn(p, d):
        return llama_loss(p, d, cfg, mesh=mesh)

    loss, grads = _value_and_grad(lambda p: loss_fn(p, local), blocks)
    gn = _grad_norm(gather_params(grads, mesh, specs))
    _close(loss, ref_loss, 1e-4, "loss", label)
    _close(gn, _grad_norm(ref_grads), 1e-3, "grad norm", label)
    out = {}
    for name, zero in (("replicated", None),
                       ("zero", ZeroConfig(mesh=mesh, bucket_bytes=1 << 16))):
        ts = train_step.make_split_train_step(
            loss_fn, precision.fused_adam(1e-3), microbatches=2, zero=zero)
        step_loss, (new, opt) = ts.step(
            ts.init(tree_map(lambda x: x.clone(), blocks)), local)
        out[name] = float(step_loss), gather_params(new, mesh, specs), opt
    _close(out["zero"][0], out["replicated"][0], 1e-5, "loss", label)
    _params_close(out["zero"][1], out["replicated"][1], 1e-4, 1e-6, label)
    return (f"dryrun_multichip[{label}]: mesh={_shape(mesh)} "
            f"loss={out['zero'][0]:.4f} grad_norm={gn:.4f} ok (matches "
            "unsharded; params match replicated fused adam; opt state "
            "sharded 2-way over data)")


def _hier_pass(cfg, seq, seed, device, label="dense/hier"):
    """``hier_allreduce`` of the unsharded gradients against ``psum``
    over both planes, and the ZeRO apply split across two planes of four
    ranks against one plane of eight on the same gradients."""
    import torch

    from horovod_tpu_torch.parallel import ops, precision
    from horovod_tpu_torch.parallel._tree import tree_leaves, tree_map
    from horovod_tpu_torch.parallel.zero import ZeroConfig, make_zero_apply

    sizes = dict(data=2, fsdp=2, tensor=2)
    mesh = _mesh(sizes, device)
    params, batch = _llama_setup(cfg, sizes, seq, seed, device)
    _, grads = _unsharded(cfg, params, batch, device)
    intra, inter = mesh.axis_group("tensor"), mesh.axis_group("fsdp")
    both = mesh.axes_group(("fsdp", "tensor"))
    for g in tree_leaves(grads):
        composed = ops.hier_allreduce(g.reshape(-1), intra, inter)
        flat = ops.psum(g.reshape(-1), both)
        _check(torch.equal(composed, flat),
               f"{label}: hier_allreduce diverged bit-wise from psum")
    k = mesh.coords["fsdp"] * 2 + mesh.coords["tensor"]
    g0 = tree_leaves(grads)[0].reshape(-1) * (1.0 + 0.25 * k)
    torch.testing.assert_close(ops.hier_allreduce(g0, intra, inter),
                               ops.psum(g0, both), rtol=1e-6, atol=1e-7)
    out = []
    for zero in (ZeroConfig(size=8, bucket_bytes=1 << 16),
                 ZeroConfig(size=4, bucket_bytes=1 << 16,
                            inter_axis="cross", inter_size=2)):
        apply_fn, init = make_zero_apply(precision.fused_adam(1e-3), zero)
        p, opt = init(tree_map(lambda x: x.clone(), params))
        out.append(apply_fn(grads, p, opt)[0])
    _params_close(out[1], out[0], 1e-5, 1e-7, label)
    return (f"dryrun_multichip[{label}]: 2x2 composed planes ok "
            "(hier_allreduce bit-matches psum on replicated operands; "
            "cross-plane ZeRO apply matches single-plane)")


def _resnet_pass(n, device, label="resnet/dp.sync-bn"):
    """ResNet-18 (width 8) over ``data=n``: the loss and gradient norm
    against the unsharded step."""
    import torch

    from horovod_tpu_torch.models import resnet

    cfg = resnet.ResNetConfig(depth=18, num_classes=7, width=8,
                              compute_dtype="float32")
    params, state = (_to(t, device) for t in resnet.resnet_init(
        cfg, torch.Generator().manual_seed(6), device="cpu"))
    g = torch.Generator().manual_seed(7)
    batch = _to({"images": torch.randn((2 * n, 16, 16, 3), generator=g),
                 "labels": torch.randint(0, cfg.num_classes, (2 * n,),
                                         generator=g)}, device)
    ref, ref_grads = _value_and_grad(lambda p: resnet.resnet_loss(
        p, state, batch, cfg, device=device)[0], params)
    mesh = _mesh(dict(data=n), device)
    local = mesh.shard_batch(batch, seq_dim=None)
    loss, grads = _value_and_grad(lambda p: resnet.resnet_loss(
        p, state, local, cfg, mesh=mesh)[0], params)
    gn = _grad_norm(grads)
    _close(loss, ref, 1e-4, "loss", label)
    _close(gn, _grad_norm(ref_grads), 1e-3, "grad norm", label)
    return (f"dryrun_multichip[{label}]: mesh={_shape(mesh)} "
            f"loss={loss:.4f} ok (matches unsharded)")


def _bert_pass(n, device, label="bert/mlm.tp.fsdp"):
    """Tiny BERT under ``tensor`` x ``fsdp`` x ``data``: the loss and
    gradient norm against the unsharded model."""
    import torch

    from horovod_tpu_torch.models import bert
    from horovod_tpu_torch.parallel.sharding import (
        gather_params,
        shard_params,
    )

    sizes = _mesh_axes_for(n, axes=("tensor", "fsdp"))
    cfg = bert.BertConfig.tiny(dtype="float32", d_model=32 * sizes["tensor"],
                               n_heads=2 * sizes["tensor"])
    params = _to(bert.bert_init(cfg, torch.Generator().manual_seed(9),
                                device="cpu"), device)
    g = torch.Generator().manual_seed(10)
    b, t = 2 * sizes["data"] * sizes["fsdp"], 16
    tokens = torch.randint(0, cfg.vocab_size, (b, t), generator=g)
    batch = _to({"tokens": tokens, "targets": tokens,
                 "mlm_mask": (torch.rand((b, t), generator=g) < 0.15).int()},
                device)
    ref, ref_grads = _value_and_grad(lambda p: bert.bert_mlm_loss(
        p, batch, cfg, device=device), params)
    mesh = _mesh(sizes, device)
    blocks, specs = shard_params(params, mesh, bert.bert_partition_rules())
    local = mesh.shard_batch(batch, seq_dim=None)
    loss, grads = _value_and_grad(lambda p: bert.bert_mlm_loss(
        p, local, cfg, mesh=mesh), blocks)
    gn = _grad_norm(gather_params(grads, mesh, specs))
    _close(loss, ref, 1e-4, "loss", label)
    _close(gn, _grad_norm(ref_grads), 1e-3, "grad norm", label)
    return (f"dryrun_multichip[{label}]: mesh={_shape(mesh)} "
            f"loss={loss:.4f} ok (matches unsharded)")


def _pipeline_passes(n, device):
    """The reference's three pipeline passes (``__graft_entry__.py:455``):
    gpipe, 1F1B and interleaved V=2 under ``pipe=2`` x ``tensor`` x
    ``fsdp``."""
    sizes = _mesh_axes_for(n, axes=("tensor", "fsdp"), fixed={"pipe": 2})
    cfg = _llama_cfg(sizes, n_layers=2 * sizes["pipe"])
    lines = [_train_one_step(cfg, sizes, 16, 4, PIPELINE_PASSES[0], device),
             _train_one_step(dataclasses.replace(
                 cfg, pipeline_schedule="1f1b"), sizes, 16, 5,
                 PIPELINE_PASSES[1], device)]
    m = 4 if (2 * sizes["data"] * sizes["fsdp"]) % 4 == 0 else 2
    lines.append(_train_one_step(dataclasses.replace(
        cfg, pipeline_schedule="interleaved_1f1b", pipeline_virtual_stages=2,
        pipeline_microbatches=m), sizes, 16, 7, PIPELINE_PASSES[2], device,
        rows=m))
    return lines


def run_passes(n, device):
    """Every pass on this rank, in the reference's order: the lines to
    print. ``device`` is ``"cpu"`` or ``"cuda"`` (this
    rank's card, ``HOROVOD_LOCAL_RANK``)."""
    import torch

    if device == "cuda":
        device = torch.device("cuda", int(os.environ["HOROVOD_LOCAL_RANK"]))
        torch.cuda.set_device(device)
        # The passes compare f32 results: no TF32 rounding.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
        # The ranks share the machine's cores: one thread each.
        torch.set_num_threads(1)
    lines = []
    sizes = _mesh_axes_for(n)
    cfg = _llama_cfg(sizes)
    seq = 8 * max(sizes["seq"], 1)
    lines.append(_train_one_step(cfg, sizes, seq, 0, "dense/dp.fsdp.tp.sp",
                                 device))
    heads = cfg.n_heads
    if sizes["seq"] > 1 and heads % sizes["seq"] == 0:
        lines.append(_train_one_step(
            dataclasses.replace(cfg, seq_parallel="ulysses"), sizes, seq, 1,
            "dense/ulysses-sp", device))
    lines.append(_split_step_pass(cfg, sizes, seq, 6, device))
    if n == 8:
        lines.append(_zero1_pass(cfg, seq, 8, device))
        lines.append(_hier_pass(cfg, seq, 9, device))
    else:
        lines += [f"dryrun_multichip[{p}]: needs 8 ranks, skipped"
                  for p in ("dense/zero1", "dense/hier")]
    msizes = _mesh_axes_for(n, axes=("tensor", "fsdp"), fixed={"expert": 2})
    lines.append(_train_one_step(_llama_cfg(msizes, moe=True), msizes, 16, 2,
                                 "moe/ep.tp.fsdp", device))
    lines += _pipeline_passes(n, device)
    lines.append(_resnet_pass(n, device))
    lines.append(_bert_pass(n, device))
    return lines


# ---- the ranks -------------------------------------------------------------


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(rank, n, port, queue, device):
    os.environ.update({
        "HOROVOD_RANK": str(rank), "HOROVOD_SIZE": str(n),
        "HOROVOD_LOCAL_RANK": str(rank), "HOROVOD_LOCAL_SIZE": str(n),
        "HOROVOD_CONTROLLER_ADDR": "127.0.0.1",
        "HOROVOD_CONTROLLER_PORT": str(port)})
    try:
        queue.put((rank, None, run_passes(n, device)))
    except Exception as e:  # noqa: BLE001 - reported by the parent
        queue.put((rank, f"{type(e).__name__}: {e}\n"
                         f"{traceback.format_exc()}", None))


def pick_device(n_devices):
    """``"cuda"`` when ``n_devices`` CUDA cards are visible (a card a
    rank), else ``"cpu"``."""
    import torch

    return "cuda" if torch.cuda.is_available() and \
        torch.cuda.device_count() >= n_devices else "cpu"


def dryrun_multichip(n_devices, device=None):
    """Run the passes on ``n_devices`` spawned ranks: on the cards (NCCL)
    or the CPU (gloo), ``device`` or else :func:`pick_device`'s choice.
    Returns a line naming where they ran and rank 0's lines. Raises if a
    rank fails or a pass does not match."""
    if n_devices < 2 or n_devices % 2:
        raise ValueError(f"dryrun_multichip needs an even number of ranks, "
                         f"got {n_devices}")
    device = device or pick_device(n_devices)
    if device not in ("cuda", "cpu"):
        raise ValueError(f"dryrun_multichip runs on cuda or cpu, not "
                         f"{device!r}")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_devices, port, queue, device))
             for r in range(n_devices)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    try:
        for _ in range(n_devices):
            rank, err, lines = queue.get(timeout=_TIMEOUT_S)
            if err is not None:
                errors[rank] = err
            results[rank] = lines
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("dryrun_multichip failed on ranks "
                           f"{sorted(errors)}:\n" + errors[min(errors)])
    where = f"{n_devices} CUDA cards (NCCL)" if device == "cuda" else \
        f"{n_devices} ranks on the CPU (gloo)"
    return [f"dryrun_multichip: {where}", *results[0]]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 8
    try:
        lines = dryrun_multichip(n)
    except Exception as e:  # noqa: BLE001 - the exit status says it
        print(f"dryrun_multichip: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    for line in lines:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
