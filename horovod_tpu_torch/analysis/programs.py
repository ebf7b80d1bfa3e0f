"""Registry of the port's shipped programs, lint-ready.

The port's copy of ``horovod_tpu/analysis/programs.py``, under the same
15 names and configs (``tiny`` and ``tiny_moe`` at ``n_layers=4``, a
batch of 4 x 8, the pipeline geometry ``S x V x M = 2 x 2 x 4``): the
monolithic and split llama steps (fused Adam, the master variant, under
a ``StepTimer``, ZeRO-1), the ZeRO apply and its cross-plane split, the
fused ZeRO step, the composed-plane allreduce, the redistribute program,
the three pipeline schedules and the ring of sequence-parallel
attention. The CLI (``python -m horovod_tpu_torch.analysis.lint --all``)
and the pytest fixture lint this set.

Each program runs on the CPU, with weights from a seed, for rank 0 and,
along each axis, the last rank of rank 0's group (:func:`_peers`): every
group rank 0 belongs to has two members run, which C1 and C8 compare;
the other checks read rank 0. Where the port's program differs from the
JAX package's:

- the split step has no optax: ``llama_train_step_split`` runs
  ``fused_adam`` as ``llama_train_step_split_fused_adam`` does;
- JAX lints its GSPMD steps on a trivial mesh, where the collectives
  are XLA's and invisible; the port's ZeRO step shards over a world of
  4 ranks, and its reduce-scatters and all-gathers are recorded;
- the pipelines run one stage a rank over ``pipe=2`` through the
  port's ``MeshTransport`` (``parallel.pipeline.build_pipeline_inner``),
  checked against ``predicted_collectives``, which skips the bubble
  slots the port exchanges nothing in.
"""

import dataclasses
import functools

import numpy as np
import torch

from horovod_tpu_torch.analysis.api import lint

# Pipeline lint geometry: S stages x V virtual chunks x M microbatches.
_S, _V, _M = 2, 2, 4
_BATCH, _SEQ = 4, 8
_ZERO_SHARDS = 4
_HIER_INTRA, _HIER_INTER = 2, 2
_DEVICE = torch.device("cpu")
#: the trivial mesh of JAX's GSPMD programs: every axis, size 1.
_TRIVIAL = [(a, 1) for a in ("pipe", "data", "fsdp", "expert", "seq",
                             "tensor")]


@dataclasses.dataclass
class LintSpec:
    """One program plus everything ``lint`` needs to analyze it:
    ``args`` a tuple or ``args(mesh) -> tuple``."""

    fn: object
    args: object
    mesh: object = None
    axis_env: object = None
    expect_collectives: object = None

    def run(self, allow=()):
        return lint(self.fn, self.args, mesh=self.mesh,
                    axis_env=self.axis_env,
                    expect_collectives=self.expect_collectives,
                    allow=allow, ranks=_peers(self.axis_env))


def _peers(axis_env):
    """Rank 0 and, along each axis larger than 1, the last rank of rank
    0's group on it, laid out as the lint's fake world lays its ranks
    (``AXIS_ORDER`` when every axis is the port mesh's)."""
    from horovod_tpu_torch.parallel.mesh import AXIS_ORDER

    sizes = dict(axis_env or ())
    order = list(AXIS_ORDER) if sizes and all(
        a in AXIS_ORDER for a in sizes) else list(sizes)
    out, stride = {0}, 1
    for a in reversed(order):
        n = sizes.get(a, 1)
        out.add((n - 1) * stride)
        stride *= n
    return tuple(sorted(out))


def _config(name):
    from horovod_tpu_torch.models.llama import LlamaConfig

    # n_layers=4 so the layer stack divides into S*V=4 pipeline chunks.
    presets = {
        "tiny": lambda: LlamaConfig.tiny(n_layers=4),
        "tiny_moe": lambda: LlamaConfig.tiny_moe(n_layers=4),
    }
    if name not in presets:
        raise ValueError(f"unknown config {name!r}: expected one of "
                         f"{sorted(presets)}")
    return presets[name]()


def _params(cfg):
    from horovod_tpu_torch.models.llama import llama_init

    return llama_init(cfg, torch.Generator().manual_seed(0), device=_DEVICE)


def _batch(cfg, rows=_BATCH):
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (rows, _SEQ + 1)).astype(np.int32)
    return {"tokens": torch.from_numpy(tok[:, :-1].copy()),
            "targets": torch.from_numpy(tok[:, 1:].copy()),
            "mask": torch.ones((rows, _SEQ), dtype=torch.float32)}


def _loss_fn(cfg, mesh):
    from horovod_tpu_torch.models.llama import llama_loss

    return functools.partial(llama_loss, config=cfg, mesh=mesh,
                             device=_DEVICE)


def _call(fn, *args):
    return fn(*args)


def _value_and_grad(mesh, cfg, params, batch):
    from horovod_tpu_torch.parallel.train_step import _value_and_grad

    return _value_and_grad(_loss_fn(cfg, mesh), params, batch, 1)


def _monolithic(config, axis_env=None):
    """One gradient call of ``llama_loss`` (the port's monolithic step:
    JAX's ``value_and_grad`` jit). On a nontrivial ``axis_env`` each
    rank runs its blocks (``shard_params`` with the llama rules) and its
    shard of the batch, and the mesh's collectives are recorded."""
    from horovod_tpu_torch.models.llama import llama_partition_rules
    from horovod_tpu_torch.parallel.sharding import shard_params

    cfg = _config(config)
    env = _TRIVIAL if axis_env is None else list(axis_env)
    rows = _BATCH * max(1, dict(env).get("data", 1) * dict(env).get(
        "fsdp", 1))

    def args(mesh):
        params = _params(cfg)
        batch = _batch(cfg, rows)
        if mesh.size > 1:
            params, _ = shard_params(params, mesh, llama_partition_rules())
            batch = mesh.shard_batch(batch)
        return (mesh, cfg, params, batch)

    return LintSpec(fn=_value_and_grad, args=args, axis_env=env)


def _split_step(make_optimizer, cfg, microbatches=2, zero=None,
                telemetry=None, mesh_loss=True):
    """``args(mesh)`` building the split step in the rank's world and
    its carry: ``(step, carry, batch)``."""
    from horovod_tpu_torch.parallel.train_step import make_split_train_step

    def args(mesh):
        ts = make_split_train_step(
            _loss_fn(cfg, mesh if mesh_loss else None), make_optimizer(),
            microbatches=microbatches, zero=zero,
            telemetry=telemetry() if telemetry else None)
        return (ts.step, ts.init(_params(cfg)), _batch(cfg))

    return args


def _split(config, optimizer_name):
    from horovod_tpu_torch.parallel import precision

    cfg = _config(config)
    make = {
        # No optax in the port: the split step takes a fused optimizer.
        "adam": lambda: precision.fused_adam(1e-3),
        "fused_adam": lambda: precision.fused_adam(1e-3),
        "fused_master_adam": lambda: precision.fused_master_adam(1e-3),
    }[optimizer_name]
    return LintSpec(fn=_call, args=_split_step(make, cfg), axis_env=_TRIVIAL)


def _split_telemetry(config):
    """The split step under a ``StepTimer``: the timer lives outside the
    step, so the recorded signature is the plain step's."""
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.telemetry.step_timer import StepTimer

    cfg = _config(config)
    return LintSpec(fn=_call, args=_split_step(
        lambda: precision.fused_adam(1e-3), cfg,
        telemetry=lambda: StepTimer(flops_per_step=1.0, block=False)),
        axis_env=_TRIVIAL)


def _split_zero(config):
    """The ZeRO-1 split step (``make_split_train_step(zero=...)``) over a
    world of 4 ranks, on the schedule ``HOROVOD_JIT_FUSION`` picks (the
    fused one by default): every bucket's reduce-scatter and all-gather
    recorded, C6 pairing them, C7 weighing each program apart."""
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    cfg = _config(config)
    zero = ZeroConfig(axis="data", size=_ZERO_SHARDS, bucket_bytes=1 << 20)
    return LintSpec(fn=_call, args=_split_step(
        lambda: precision.fused_adam(1e-3), cfg, zero=zero,
        mesh_loss=False), axis_env=[("data", _ZERO_SHARDS)])


def _zero_layout(cfg, n_shards, bucket_bytes):
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.zero import zero_bucket_layout

    return zero_bucket_layout(tree_leaves(_params(cfg)), n_shards,
                              bucket_bytes)


def _apply(program, grads, leaves, opt):
    return program.apply(grads, leaves, opt)


def _zero_apply_args(cfg, zero):
    """``args(mesh)``: the unfused ZeRO apply of the rank's world
    (``ZeroApply``), gradients from a seed, the params' leaves and the
    rank's state."""
    from horovod_tpu_torch.parallel import precision
    from horovod_tpu_torch.parallel._tree import tree_leaves
    from horovod_tpu_torch.parallel.zero import (
        ZeroApply,
        zero_axis,
        zero_bucket_layout,
        zero_state_init,
    )

    def args(mesh):
        params = _params(cfg)
        leaves = tree_leaves(params)
        hyper = precision.fused_adam(1e-3).hyper
        axis = zero_axis(zero, _DEVICE)
        layout = zero_bucket_layout(leaves, axis.size, zero.bucket_bytes)
        _, opt = zero_state_init(hyper, layout, params, axis)
        gen = torch.Generator().manual_seed(1)
        grads = [torch.randn(x.shape, generator=gen).to(x.dtype)
                 for x in leaves]
        return (ZeroApply(hyper, layout, axis), grads, leaves, opt)

    return args


def _zero_shard_apply(config):
    """The per-rank ZeRO apply at the llama geometry (one bucket
    reduce-scattered, the shard's Adam, all-gathered), held to
    ``predicted_zero_collectives`` (C5) and paired (C6)."""
    from horovod_tpu_torch.parallel.ops import predicted_zero_collectives
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    cfg = _config(config)
    zero = ZeroConfig(axis="data", size=_ZERO_SHARDS, bucket_bytes=1 << 20)
    n = len(_zero_layout(cfg, _ZERO_SHARDS, zero.bucket_bytes).buckets)
    return LintSpec(fn=_apply, args=_zero_apply_args(cfg, zero),
                    axis_env=[("data", _ZERO_SHARDS)],
                    expect_collectives=predicted_zero_collectives(n, "data"))


def _zero_shard_apply_hier(config):
    """The cross-plane ZeRO apply (``ZeroConfig(inter_axis=...)``): the
    pair on ``data`` (4 consecutive ranks), the shard summed over
    ``cross`` (2 planes) between them. The world is laid out planes
    first, as ``zero_axis`` splits it."""
    from horovod_tpu_torch.parallel.ops import predicted_zero_collectives
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    cfg = _config(config)
    zero = ZeroConfig(axis="data", size=_ZERO_SHARDS, bucket_bytes=1 << 20,
                      inter_axis="cross", inter_size=_HIER_INTER)
    n = len(_zero_layout(cfg, _ZERO_SHARDS, zero.bucket_bytes).buckets)
    return LintSpec(fn=_apply, args=_zero_apply_args(cfg, zero),
                    axis_env=[("cross", _HIER_INTER), ("data", _ZERO_SHARDS)],
                    expect_collectives=predicted_zero_collectives(
                        n, "data", inter_axis="cross"))


def _zero_fused_step(config):
    """The fused ZeRO-1 step (one gradient call; each bucket's
    reduce-scatter started from the backward's hook as the bucket
    completes, ``parallel/fusion.py``), small buckets so the tiny config
    splits into many: C7 proves the scatters interleave with the
    backward, C6 pairs each with its all-gather."""
    from horovod_tpu_torch.parallel import fusion, precision
    from horovod_tpu_torch.parallel.zero import ZeroConfig

    cfg = _config(config)
    zero = ZeroConfig(axis="data", size=_ZERO_SHARDS, bucket_bytes=1 << 15)
    build = _split_step(lambda: precision.fused_adam(1e-3), cfg,
                        microbatches=1, zero=zero, mesh_loss=False)

    def args(mesh):
        before = fusion._override
        fusion.set_jit_fusion(True)
        try:
            return build(mesh)
        finally:
            fusion._override = before

    return LintSpec(fn=_call, args=args, axis_env=[("data", _ZERO_SHARDS)])


def _hier(mesh, x):
    from horovod_tpu_torch.parallel.ops import hier_allreduce

    return hier_allreduce(x, mesh.axis_group("intra"),
                          mesh.axis_group("inter"))


def _hier_allreduce(config):
    """The composed-plane allreduce (``parallel.ops.hier_allreduce``):
    reduce-scatter over ``intra``, psum of the shard over ``inter``,
    all-gather back; C5 against ``predicted_hier_collectives``."""
    del config
    from horovod_tpu_torch.parallel.ops import predicted_hier_collectives

    x = torch.ones((8 * _HIER_INTRA, 4))
    return LintSpec(
        fn=_hier, args=lambda mesh: (mesh, x.clone()),
        axis_env=[("intra", _HIER_INTRA), ("inter", _HIER_INTER)],
        expect_collectives=predicted_hier_collectives("intra", "inter"))


def _gather_rows(mesh, x):
    from horovod_tpu_torch.parallel.ops import all_gather

    return all_gather(x, mesh.axis_group("shard"), 0)


def _redistribute_to_replicated(config):
    """The sharded -> replicated redistribute as one all-gather, C5's
    expectation taken from the plan itself
    (``ReshardPlan.expected_collectives``)."""
    del config
    from horovod_tpu_torch.parallel.reshard import Layout, plan_redistribute

    shards, rows = 4, 16
    plan = plan_redistribute((rows, 4), np.float32,
                             Layout.sharded(rows, shards),
                             Layout.replicated(shards))
    x = torch.ones((rows // shards, 4))
    return LintSpec(fn=_gather_rows, args=lambda mesh: (mesh, x.clone()),
                    axis_env=[("shard", shards)],
                    expect_collectives=plan.expected_collectives("shard"))


def _pipeline(config, schedule):
    """A schedule over ``pipe=2`` through the port's ``MeshTransport``,
    one stage a rank (``build_pipeline_inner``), held to
    ``predicted_collectives`` for the stage (C5)."""
    from horovod_tpu_torch.models.llama import llama_pipeline_programs
    from horovod_tpu_torch.parallel.pipeline import (
        build_pipeline_inner,
        mesh_transport,
        predicted_collectives,
    )

    cfg = _config(config)
    V = _V if schedule == "interleaved_1f1b" else 1
    stage_fn, loss_fn, aux_ct = llama_pipeline_programs(
        cfg, mesh=None, microbatches=_M, denom=float(_BATCH * _SEQ))
    expect = predicted_collectives(schedule, S=_S, M=_M, num_virtual=V,
                                   n_head_leaves=2)
    mb, d = _BATCH // _M, cfg.d_model

    def args(mesh):
        inner = build_pipeline_inner(
            schedule, stage_fn, loss_fn, S=_S, M=_M, num_virtual=V,
            transport=mesh_transport(mesh), aux_cotangent=aux_ct)
        params = _params(cfg)
        # This rank's block of the stacked layers: L / S rows (V chunks
        # of L / (S V) under the interleaved schedule).
        lb = cfg.n_layers // _S
        stage = mesh.axis_index("pipe")
        sp = {k: w[stage * lb:(stage + 1) * lb].clone()
              for k, w in params["layers"].items()}
        gen = torch.Generator().manual_seed(2)
        xs = torch.randn((_M, mb, _SEQ, d), generator=gen).to(
            cfg.compute_dtype)
        if schedule == "gpipe":
            return (inner, sp, xs)
        hp = [params["final_norm"], params["lm_head"]]
        b = _batch(cfg)
        largs = (b["targets"].reshape(_M, mb, _SEQ),
                 b["mask"].reshape(_M, mb, _SEQ))
        return (inner, sp, hp, xs, largs)

    return LintSpec(fn=_call, args=args, axis_env=[("pipe", _S)],
                    expect_collectives=expect)


def _ring(mesh, q, k, v):
    from horovod_tpu_torch.parallel.ring_attention import ring_attention

    return ring_attention(q, k, v, mesh, "sp", causal=True, use_flash=False)


def _ring_attention(config):
    """The sequence-parallel exact-attention ring
    (``parallel.ring_attention``, blockwise path): n-1 ``ppermute`` hops
    of the K/V shards around ``sp``, a rank-dependent causal mask each
    step (rank-dependent VALUES in rank-invariant control flow: quiet)."""
    del config
    gen = torch.Generator().manual_seed(3)
    # GQA geometry: 4 query heads over 2 KV heads, bf16 activations.
    q = torch.randn((2, 8, 4, 8), generator=gen).to(torch.bfloat16)
    kv = torch.randn((2, 8, 2, 8), generator=gen).to(torch.bfloat16)
    return LintSpec(fn=_ring,
                    args=lambda mesh: (mesh, q.clone(), kv.clone(),
                                       kv.clone()),
                    axis_env=[("sp", 2)])


_REGISTRY = {
    "llama_train_step": _monolithic,
    "llama_train_step_split":
        functools.partial(_split, optimizer_name="adam"),
    "llama_train_step_split_fused_adam":
        functools.partial(_split, optimizer_name="fused_adam"),
    "llama_train_step_split_fused_master_adam":
        functools.partial(_split, optimizer_name="fused_master_adam"),
    "llama_train_step_split_telemetry": _split_telemetry,
    "llama_train_step_split_zero1": _split_zero,
    "zero1_shard_apply": _zero_shard_apply,
    "zero1_shard_apply_hier": _zero_shard_apply_hier,
    "zero1_fused_step": _zero_fused_step,
    "hier_allreduce": _hier_allreduce,
    "redistribute_to_replicated": _redistribute_to_replicated,
    "pipeline_gpipe":
        functools.partial(_pipeline, schedule="gpipe"),
    "pipeline_1f1b":
        functools.partial(_pipeline, schedule="1f1b"),
    "pipeline_interleaved_1f1b":
        functools.partial(_pipeline, schedule="interleaved_1f1b"),
    "ring_attention_sp": _ring_attention,
}


def program_names():
    return sorted(_REGISTRY)


def build_program(name, config="tiny"):
    """Build a registered program's :class:`LintSpec`."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown program {name!r}: expected one of "
                         f"{program_names()}")
    return _REGISTRY[name](config)


def lint_program(name, config="tiny", allow=()):
    """Build and lint one registered program."""
    return build_program(name, config).run(allow=allow)


def lint_all(config="tiny", allow=()):
    """Lint every registered program; returns ``{name: [Diagnostic]}``."""
    return {name: lint_program(name, config, allow)
            for name in program_names()}
