"""Llama-family decoder-only transformer: the port's dense and sparse
mixture-of-experts model.

Counterpart of horovod_tpu/models/llama.py. Parameters are a plain dict
with the JAX package's keys and stacked [L, ...] shapes (so a JAX tree
converts leaf for leaf, see ``convert.py``); the helpers are plain
functions on tensors, with the same numeric recipe as the JAX ones.

Ported here: ``LlamaConfig``, ``llama_init`` (dense and MoE trees),
``llama_partition_rules``, ``_rmsnorm``, ``_rope``, ``moe_route``,
``_ffn`` (dense SwiGLU, the dropless grouped MoE dispatch of
``ops/grouped_moe.py``, or the GShard dispatch ``_moe_ffn``), and the
training forward: ``llama_forward`` and ``llama_loss`` (the JAX
``lax.scan`` over layers is a Python loop over the unbound layer slices)
with every remat mode of the JAX package (``none``, ``full``, ``dots``,
``attn``, ``attn+gate``, ``attn+gate+qkv``, ``attn+ffn``, ``attn+moe``,
``moe``), on one device or under a mesh (``parallel/mesh.py``) of the
``pipe``, ``data``, ``fsdp``, ``seq``, ``expert`` and ``tensor`` axes.
There each rank runs its shard of the batch and its blocks of the params
(``parallel/sharding.py``), and the model inserts the collectives JAX's
GSPMD inserts: the ``fsdp`` leaves gathered one layer at a time (their
gradients reduce-scattered), Megatron's tensor parallelism
(column-parallel q/k/v and gate/up, row-parallel wo and down,
``replicate`` in and ``psum`` out, the vocab-parallel lm_head and
cross-entropy), the experts of the ``expert`` axis, attention over the
``seq`` axis by ring or Ulysses (``seq_parallel``) on the rank's heads,
rope positions and the loss's mean global, and each leaf's gradient
summed over the batch axes its spec leaves replicated; the dropless
grouped dispatch runs there on each rank's tokens
(``ops/grouped_moe.py``). A ``pipe`` axis larger than 1 cuts the layer
stack into stages (``parallel/pipeline.py``): ``llama_forward`` and a
``gpipe`` config's ``llama_loss`` run the layers through gpipe, a
``1f1b`` or ``interleaved_1f1b`` config's ``llama_loss`` through the
fused schedule with the loss head on the last stage
(:func:`llama_pipeline_programs`); ``transport=`` replays the same
pipeline with all its stages in this process.

Remat is PyTorch's selective activation checkpointing, which decides per
dispatcher op. The JAX save-names map onto ops: ``flash_o``/``flash_lse``
are the outputs of the flash op ``hvd_torch::flash_fwd`` (K1), and
``ffn_gate``/``ffn_up`` are the pre-silu gate and the up-projection,
produced by the named matmul op ``hvd_torch::named_matmul``; the MoE
names are the outputs of the grouped-MoE ops (``ops/grouped_moe.py``),
and the GShard dispatch's ``moe_dispatch``/``moe_combine`` are
``hvd_torch::checkpoint_name`` outputs; the post-rope
``rope_q``/``rope_k`` and ``attn_v`` are the outputs of one op,
``hvd_torch::qkv_rope`` (the three projections and the rotation), so
``attn+gate+qkv`` re-runs neither (torch's replay has no dead-code
elimination: an unsaved projection before a saved rotation would run
again). On the sequence-parallel path each ring step's chunk op
``hvd_torch::flash_chunk`` gives ``flash_o``/``flash_lse`` and the
attention output is named ``attn_out`` by ``hvd_torch::checkpoint_name``,
as JAX names it there.

``dots`` (JAX's ``dots_saveable``) saves what the TPU program saves:
every matmul of the layer (``aten.mm``/``bmm``/``addmm``/``matmul``,
``hvd_torch::named_matmul`` and ``hvd_torch::qkv_rope``, the GShard
einsums among them), and
recomputes the rest, K1 (``hvd_torch::flash_fwd``/``flash_chunk``) and
the grouped products (``hvd_torch::gmm``, ``gmm_unpermute``) included:
on the TPU those are ``pallas_call``s, not dots. JAX's CPU run of the
same mode saves its attention, an XLA einsum there, so its recompute
count on the CPU is not the TPU program's; the gradients are the same.

``qkv_rope`` and ``named_matmul`` carry FLOP formulas (their forwards'
matmuls; their backwards are plain matmuls), so a FLOP counter counts a
step as its plain matmuls would (``telemetry/step_timer.py
count_flops``).
"""

import dataclasses
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)
from torch.utils.flop_counter import register_flop_formula

from horovod_tpu_torch._device import on_device, resolve_device
from horovod_tpu_torch.ops import grouped_moe
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten
from horovod_tpu_torch.parallel.mesh import BATCH_AXES, ROW_AXES
from horovod_tpu_torch.parallel import pipeline
from horovod_tpu_torch.parallel.ops import (
    all_gather,
    all_gather_invariant,
    psum,
    replicate,
)
from horovod_tpu_torch.parallel.ring_attention import ring_self_attention
from horovod_tpu_torch.parallel.sharding import (
    Interleaved,
    P,
    block_specs,
    param_specs,
)
from horovod_tpu_torch.parallel.ulysses import ulysses_self_attention

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name):
    """The torch dtype of a config dtype string."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype {name!r}: expected one of "
                         f"{sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Field-for-field mirror of the JAX ``LlamaConfig`` (see its
    comments for each field). Fields the port does not use (scan and
    flash tuning) are kept so that one config describes one model in
    both packages."""

    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: "bool | str" = True
    n_experts: int = 0
    n_experts_per_token: int = 2
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_impl: str = "auto"
    pipeline_microbatches: int = 0
    pipeline_schedule: str = "gpipe"
    pipeline_virtual_stages: int = 1
    seq_parallel: str = "ring"
    scan_unroll: int = 1
    flash_block: int = 0
    param_dtype: str = "float32"

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self):
        return torch_dtype(self.dtype)

    @staticmethod
    def llama3_8b():
        return LlamaConfig(vocab_size=128256, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, d_ff=14336)

    @staticmethod
    def mixtral_8x7b():
        return LlamaConfig(vocab_size=32000, d_model=4096, n_layers=32,
                           n_heads=32, n_kv_heads=8, d_ff=14336,
                           n_experts=8, n_experts_per_token=2)

    @staticmethod
    def tiny(**kw):
        """Test config: full architecture, toy sizes."""
        defaults = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_ff=128, rope_theta=10000.0)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def tiny_moe(**kw):
        """Tiny sparse-MoE variant of :meth:`tiny`."""
        kw.setdefault("n_experts", 4)
        return LlamaConfig.tiny(**kw)


def llama_init(config, generator, device=None):
    """Random parameters with the JAX ``llama_init``'s keys, shapes and
    ``param_dtype`` (the values differ: torch and JAX draw different
    streams from one seed). Normals are drawn on ``generator``'s device
    in f32, scaled by fan_in^-1/2 and cast per leaf, so no whole-tree
    f32 copy is ever held. MoE configs get ``router`` [L, D, E] and
    ``moe_gate``/``moe_up`` [L, E, D, F], ``moe_down`` [L, E, F, D] in
    place of the dense FFN weights."""
    c = config
    dev = resolve_device(device)
    pd = torch_dtype(c.param_dtype)
    hd = c.head_dim
    L = c.n_layers

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(std).to(device=dev, dtype=pd)

    def dense(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    layers = {
        "attn_norm": torch.ones((L, c.d_model), dtype=pd, device=dev),
        "wq": dense((L, c.d_model, c.n_heads * hd), c.d_model),
        "wk": dense((L, c.d_model, c.n_kv_heads * hd), c.d_model),
        "wv": dense((L, c.d_model, c.n_kv_heads * hd), c.d_model),
        "wo": dense((L, c.n_heads * hd, c.d_model), c.n_heads * hd),
        "mlp_norm": torch.ones((L, c.d_model), dtype=pd, device=dev),
    }
    if c.n_experts > 0:
        E = c.n_experts
        layers.update({
            "router": dense((L, c.d_model, E), c.d_model),
            "moe_gate": dense((L, E, c.d_model, c.d_ff), c.d_model),
            "moe_up": dense((L, E, c.d_model, c.d_ff), c.d_model),
            "moe_down": dense((L, E, c.d_ff, c.d_model), c.d_ff),
        })
    else:
        layers.update({
            "w_gate": dense((L, c.d_model, c.d_ff), c.d_model),
            "w_up": dense((L, c.d_model, c.d_ff), c.d_model),
            "w_down": dense((L, c.d_ff, c.d_model), c.d_ff),
        })
    return {
        "embed": normal((c.vocab_size, c.d_model), 0.02),
        "layers": layers,
        "final_norm": torch.ones(c.d_model, dtype=pd, device=dev),
        "lm_head": dense((c.d_model, c.vocab_size), c.d_model),
    }


def _rmsnorm(x, scale, eps):
    """f32 variance, normalise, cast back to x's dtype, then scale."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def _rope(x, positions, theta):
    """Rotary embedding at GLOBAL positions [B, T]; x [B, T, H, D].
    cos/sin are computed in f32 and cast to x's dtype before the
    rotation, as in the JAX package."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = positions[:, :, None].float() * freqs        # [B, T, d/2]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


@torch.library.custom_op("hvd_torch::qkv_rope", mutates_args=())
def qkv_rope(h: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
             wv: torch.Tensor, positions: torch.Tensor, theta: float,
             head_dim: int) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The attention inputs of ``h`` [B, T, D] as one dispatcher op: q
    and k projected and rotated (:func:`_rope` at ``positions``), v
    projected, each [B, T, heads, head_dim]. Its outputs are JAX's
    post-rope ``rope_q``/``rope_k`` and ``attn_v``: one op, so a remat
    policy that saves them re-runs neither the projections nor the
    rotation."""
    bb, tt = h.shape[0], h.shape[1]
    q = torch.matmul(h, wq).reshape(bb, tt, -1, head_dim)
    k = torch.matmul(h, wk).reshape(bb, tt, -1, head_dim)
    v = torch.matmul(h, wv).reshape(bb, tt, -1, head_dim)
    return _rope(q, positions, theta), _rope(k, positions, theta), v


def _qkv_rope_setup(ctx, inputs, output):
    h, wq, wk, wv, positions, theta, _ = inputs
    ctx.save_for_backward(h, wq, wk, wv, positions)
    ctx.theta = theta


def _qkv_rope_backward(ctx, dq, dk, dv):
    h, wq, wk, wv, positions = ctx.saved_tensors
    flat = h.reshape(-1, h.shape[-1])
    dh, dws = None, []
    # The rotation's transpose is the rotation by -positions.
    for g, w in ((_rope(dq, -positions, ctx.theta), wq),
                 (_rope(dk, -positions, ctx.theta), wk), (dv, wv)):
        g = g.reshape(-1, w.shape[-1])
        part = torch.matmul(g, w.transpose(0, 1))
        dh = part if dh is None else dh + part
        dws.append(torch.matmul(flat.transpose(0, 1), g))
    return dh.reshape(h.shape), *dws, None, None, None


torch.library.register_autograd("hvd_torch::qkv_rope", _qkv_rope_backward,
                                setup_context=_qkv_rope_setup)


@torch.library.custom_op("hvd_torch::named_matmul", mutates_args=())
def named_matmul(x: torch.Tensor, w: torch.Tensor,
                 name: str) -> torch.Tensor:
    """x @ w as one dispatcher op carrying a save-name, so a remat
    policy can keep its output (JAX's ``checkpoint_name``)."""
    return torch.matmul(x, w)


def _named_matmul_setup(ctx, inputs, output):
    x, w, _ = inputs
    ctx.save_for_backward(x, w)


def _named_matmul_backward(ctx, g):
    x, w = ctx.saved_tensors
    dx = torch.matmul(g, w.transpose(-1, -2))
    dw = torch.matmul(x.reshape(-1, x.shape[-1]).transpose(0, 1),
                      g.reshape(-1, g.shape[-1]))
    return dx, dw, None


torch.library.register_autograd("hvd_torch::named_matmul",
                                _named_matmul_backward,
                                setup_context=_named_matmul_setup)


# FLOP formulas of the two matmul ops: what their plain matmuls count
# (their backwards are plain matmuls, which a FLOP counter sees).
@register_flop_formula(torch.ops.hvd_torch.qkv_rope)
def _qkv_rope_flops(h_shape, wq_shape, wk_shape, wv_shape, *args, **kwargs):
    rows = math.prod(h_shape[:-1])
    return 2 * rows * h_shape[-1] * (wq_shape[1] + wk_shape[1]
                                     + wv_shape[1])


@register_flop_formula(torch.ops.hvd_torch.named_matmul)
def _named_matmul_flops(x_shape, w_shape, *args, **kwargs):
    return 2 * math.prod(x_shape[:-1]) * x_shape[-1] * w_shape[-1]


@torch.library.custom_op("hvd_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under a save-name (JAX's ``checkpoint_name``): a copy made
    by one dispatcher op, so a remat policy can keep it."""
    return x.clone()


torch.library.register_autograd(
    "hvd_torch::checkpoint_name", lambda ctx, g: (g, None),
    setup_context=lambda ctx, inputs, output: None)


def _route(h, router_w, k):
    """:func:`moe_route` before its aux loss: (gate_vals, gate_idx,
    probs [..., E] f32)."""
    logits = h.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # [..., E]
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = ranked.values[..., :k]
    gate_idx = ranked.indices[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, gate_idx.int(), probs


def _switch_aux(probs, gate_idx, group=None, n_shards=1):
    """E * <fraction routed top-1 to e> . <mean prob of e>, the means
    over every token: over all leading axes, and under a mesh over the
    ``n_shards`` blocks of the batch that ``group`` sums."""
    E = probs.shape[-1]
    lead = tuple(range(probs.dim() - 1))
    experts = torch.arange(E, device=probs.device)
    top1 = (gate_idx[..., :1] == experts).float()
    if group is None:
        return E * torch.sum(top1.mean(lead) * probs.mean(lead))
    n = probs.numel() // E * n_shards
    return E * torch.sum(psum(top1.sum(lead), group) / n
                         * (psum(probs.sum(lead), group) / n))


def moe_route(h, router_w, n_experts_per_token):
    """The one router, shared by both dispatches and cached decode:
    f32 logits product, softmax, top-K (descending, as ``lax.top_k``),
    the epsilon-guarded gate normalisation and the Switch
    load-balancing aux loss E * <fraction routed top-1 to e> . <mean
    prob of e>, with means over all leading axes.

    The top-K is the first K columns of a stable descending sort, not
    ``torch.topk``: ``lax.top_k`` puts the lower expert index first when
    two probabilities are exactly equal, and ``torch.topk`` promises no
    order on ties, so a tie could pick (or rank first) another expert.

    ``h`` is [..., D]; returns (gate_vals [..., K] f32, gate_idx
    [..., K] int32, aux). The one-hot is a compare with the expert ids:
    ``F.one_hot`` on CUDA reads the indices' range on the host."""
    gate_vals, gate_idx, probs = _route(h, router_w, n_experts_per_token)
    return gate_vals, gate_idx, _switch_aux(probs, gate_idx)


def _group(mesh, *axes):
    """``mesh``'s group over ``axes`` (None without a mesh)."""
    return None if mesh is None else mesh.axes_group(axes)


def _moe_ffn(h, lp, c, mesh=None, seq_axis="seq"):
    """Top-K routed expert FFN, the GShard dispatch (the JAX
    ``_moe_ffn``): each batch row is a dispatch group; within it the
    (token, slot) pairs scatter into per-expert buffers of capacity
    C = max(int(T K capacity_factor / E), 1) by one-hot tensors,
    filling slot 0 for every token before slot 1, and a pair over
    capacity falls through on the residual (combine weight 0). The
    dispatch and combine tensors [B, T, E, C] are built in the compute
    dtype and named ``moe_dispatch``/``moe_combine`` for
    ``remat="attn+gate"``; the products are plain einsums, as in JAX.

    Under ``mesh`` (JAX's layout: tokens split over the batch and
    ``seq`` axes and replicated over ``expert`` and ``tensor``, the
    experts split over ``expert``, each expert's F over ``tensor``) every
    rank routes its tokens alike and builds the dispatch of its own
    E/expert experts, runs them on its F block, and the partial outputs
    are summed over ``expert`` and ``tensor``. No token moves between
    ranks. T is the global row length: a ``seq`` rank's positions
    start after the earlier ``seq`` ranks' counts, as JAX's cumsum over
    the whole row does. The aux loss's means are the global batch's.
    Returns (out [B, T, D], aux loss)."""
    b, t, _ = h.shape
    E, K = c.n_experts, c.n_experts_per_token
    dt = c.compute_dtype
    n_seq = mesh.shape.get(seq_axis, 1) if mesh is not None and seq_axis \
        else 1
    C = max(int(t * n_seq * K * c.capacity_factor / E), 1)
    gate_vals, gate_idx, probs = _route(h, lp["router"], K)
    if mesh is None:
        aux = _switch_aux(probs, gate_idx)
    else:
        aux = _switch_aux(probs, gate_idx, mesh.batch_group(),
                          mesh.axes_size(BATCH_AXES))
    n_exp = 1 if mesh is None else mesh.shape["expert"]
    if E % n_exp:
        raise ValueError(f"n_experts ({E}) does not split over the "
                         f"'expert' axis ({n_exp})")
    lo = 0 if mesh is None else mesh.axis_index("expert") * (E // n_exp)
    experts = torch.arange(lo, lo + E // n_exp, device=h.device)
    onehot = (gate_idx[..., None] == experts).long()          # [B,T,K,E']
    per_slot = onehot.sum(1)                                  # [B,K,E']
    before, total = torch.zeros_like(per_slot), per_slot
    if n_seq > 1:
        every = all_gather(per_slot[None], mesh.axis_group(seq_axis))
        before = every[:mesh.axis_index(seq_axis)].sum(0)
        total = every.sum(0)
    et = _group(mesh, "expert", "tensor")
    (gv,) = replicate((gate_vals,), et)
    slots = torch.arange(C, device=h.device)
    counts = torch.zeros_like(total[:, 0])
    dispatch = combine = None
    for slot in range(K):
        oh = onehot[:, :, slot]                                # [B,T,E']
        pos = oh.cumsum(1) - 1 + (counts + before[:, slot])[:, None, :]
        keep = (pos < C) & (oh > 0)
        pos_oh = ((pos[..., None] == slots) & keep[..., None]).to(dt)
        w = pos_oh * gv[..., slot].to(dt)[..., None, None]
        dispatch = pos_oh if dispatch is None else dispatch + pos_oh
        combine = w if combine is None else combine + w
        counts = counts + total[:, slot]
    dispatch = checkpoint_name(dispatch, "moe_dispatch")
    combine = checkpoint_name(combine, "moe_combine")
    (hd,) = replicate((h,), et)
    xe = torch.einsum("btec,btd->becd", dispatch, hd.to(dt))  # [B,E',C,D]
    gate = F.silu(torch.einsum("becd,edf->becf", xe, lp["moe_gate"].to(dt)))
    up = torch.einsum("becd,edf->becf", xe, lp["moe_up"].to(dt))
    ye = torch.einsum("becf,efd->becd", gate * up, lp["moe_down"].to(dt))
    y = torch.einsum("btec,becd->btd", combine, ye)
    return psum(y, et), aux


def _dense_ffn(h, lp, c, tensor=None):
    """The SwiGLU MLP on this rank's blocks: w_gate/w_up column blocks,
    w_down a row block, the partial output summed over ``tensor``
    (Megatron; None: this rank's partial sum). The pre-silu gate is
    named ``ffn_gate`` for remat="attn+gate", the up-projection
    ``ffn_up`` for "attn+ffn"."""
    dt = c.compute_dtype
    (h,) = replicate((h,), tensor)
    gate = named_matmul(h, lp["w_gate"].to(dt), "ffn_gate")
    up = named_matmul(h, lp["w_up"].to(dt), "ffn_up")
    return psum((F.silu(gate) * up) @ lp["w_down"].to(dt), tensor)


def _grouped(c, mesh):
    """Whether ``c``'s MoE layers take the dropless grouped dispatch:
    ``moe_impl`` "grouped", or "auto" without a mesh."""
    return c.n_experts > 0 and (c.moe_impl == "grouped" or (
        c.moe_impl == "auto" and mesh is None))


def _ffn(h, lp, c, mesh=None, seq_axis="seq"):
    """One layer's FFN on normalised activations: the dense SwiGLU, or
    top-K expert routing for MoE configs, dispatched as the JAX
    ``_ffn``: ``moe_impl`` "grouped", or "auto" without a mesh, takes
    the dropless grouped path (K5/K6; under a mesh on each rank's tokens
    and F/tensor block of every expert, ``ops/grouped_moe.py``);
    "gshard", or "auto" under a mesh, the GShard dispatch. Returns (y,
    aux_loss) (aux is 0 when dense)."""
    if c.n_experts > 0:
        if _grouped(c, mesh):
            return grouped_moe.grouped_moe_ffn(h, lp, c, mesh)
        if c.moe_impl not in ("auto", "gshard"):
            raise ValueError(f"unknown moe_impl {c.moe_impl!r}: expected "
                             "'auto', 'grouped', or 'gshard'")
        return _moe_ffn(h, lp, c, mesh, seq_axis)
    return (_dense_ffn(h, lp, c, _group(mesh, "tensor")),
            torch.zeros((), dtype=torch.float32, device=h.device))


def _attention(q, k, v, mesh=None, seq_axis="seq", seq_parallel="ring"):
    """Causal attention of q [B, T, H, D], k/v [B, T, Hkv, D]: with a
    mesh whose ``seq_axis`` is larger than 1, this rank's sequence shard
    through ring attention (the chunk op per step) or, for
    ``seq_parallel="ulysses"``, Ulysses, the output named ``attn_out``;
    otherwise the flash op (K1 forward, K2/K3 backward)."""
    if mesh is not None and seq_axis and mesh.shape.get(seq_axis, 1) > 1:
        if seq_parallel == "ulysses":
            out = ulysses_self_attention(q, k, v, mesh, causal=True,
                                         seq_axis=seq_axis)
        elif seq_parallel in ("ring", None):
            out = ring_self_attention(q, k, v, mesh, causal=True,
                                      seq_axis=seq_axis)
        else:
            raise ValueError(f"unknown seq_parallel {seq_parallel!r}: "
                             "expected 'ring' or 'ulysses'")
        return checkpoint_name(out, "attn_out")
    return flash_attention(q, k, v, causal=True)


def _attention_block(x, lp, c, positions, tensor=None, mesh=None,
                     seq_axis="seq"):
    """The attention sublayer's output on this rank's blocks (the
    residual not added): rmsnorm, q/k/v by the column blocks of
    wq/wk/wv (this rank's heads: H/tensor and Hkv/tensor, head h still
    reading kv head h // n_rep), rope at ``positions``, attention, the
    row block of wo, the partial output summed over ``tensor``
    (Megatron; None: this rank's partial sum). The post-rope q and k and
    the v (``rope_q``, ``rope_k``, ``attn_v``) are :func:`qkv_rope`'s."""
    dt = c.compute_dtype
    bb, tt = x.shape[0], x.shape[1]
    h = _rmsnorm(x, lp["attn_norm"].to(dt), c.norm_eps)
    (h,) = replicate((h,), tensor)
    q, kk, vv = qkv_rope(h, lp["wq"].to(dt), lp["wk"].to(dt),
                         lp["wv"].to(dt), positions, float(c.rope_theta),
                         c.head_dim)
    attn = _attention(q, kk, vv, mesh, seq_axis, c.seq_parallel)
    return psum(attn.reshape(bb, tt, -1) @ lp["wo"].to(dt), tensor)


_FLASH_OPS = (torch.ops.hvd_torch.flash_fwd.default,
              torch.ops.hvd_torch.flash_chunk.default)
_NAMED_OP = torch.ops.hvd_torch.named_matmul.default
_QKV_OP = torch.ops.hvd_torch.qkv_rope.default
_NAME_OP = torch.ops.hvd_torch.checkpoint_name.default
_GMM_OP = torch.ops.hvd_torch.gmm.default
_Y_SLOTS_OP = torch.ops.hvd_torch.gmm_unpermute.default
_X_SORTED_OP = torch.ops.hvd_torch.dispatch_gather.default

# The JAX save-sets of the modes that save by name
# (horovod_tpu/models/llama.py _build_layer_body).
_MOE_EXTRA_SAVE = ("moe_x_sorted", "moe_gate_act", "moe_up_act")
_ATTN_GATE = ("attn_out", "flash_o", "flash_lse", "ffn_gate",
              "moe_dispatch", "moe_combine")
_REMAT_SAVES = {
    "attn": ("attn_out", "flash_o", "flash_lse"),
    "attn+gate": _ATTN_GATE,
    "attn+gate+qkv": (*_ATTN_GATE, "rope_q", "rope_k", "attn_v"),
    "attn+ffn": (*_ATTN_GATE, "ffn_up"),
    "attn+moe": ("attn_out", "flash_o", "flash_lse", "moe_y_slots"),
    "moe": ("attn_out", "flash_o", "flash_lse", "moe_y_slots",
            *_MOE_EXTRA_SAVE),
}
# remat="dots": the layer's matmuls, as the TPU program's dots_saveable
# saves its dot_generals (K1 and the grouped products are pallas_calls
# there, so they are not among them).
_aten = torch.ops.aten
_DOT_OPS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
            _aten.baddbmm.default, _aten.matmul.default, _aten.dot.default,
            _aten.mv.default, _NAMED_OP)
# The projections inside hvd_torch::qkv_rope are dots too: under "dots"
# the op's outputs (rotated by elementwise work) are saved with them, as
# XLA saves the dot outputs and re-runs only the rotation. The port's op
# holds both, so it is saved whole.


def _save_only_these_names(names):
    """A selective-checkpoint policy saving the ops that produce
    ``names`` and recomputing everything else in the backward."""
    def policy(ctx, op, *args, **kwargs):
        if op in _FLASH_OPS:
            saved = "flash_o" in names
        elif op is _NAMED_OP:
            saved = args[2] in names
        elif op is _QKV_OP:
            saved = "rope_q" in names
        elif op is _NAME_OP:
            saved = args[1] in names
        elif op is _GMM_OP:
            saved = args[3] in names
        elif op is _Y_SLOTS_OP:
            saved = "moe_y_slots" in names
        elif op is _X_SORTED_OP:
            saved = "moe_x_sorted" in names
        else:
            saved = False
        return (CheckpointPolicy.MUST_SAVE if saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _save_dots():
    """The selective-checkpoint policy of remat="dots"."""
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in _DOT_OPS
                or op is _QKV_OP else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _gather_leaf(w, spec, mesh, axis, invariant=False):
    """``w``'s dims that ``spec`` splits over ``axis`` gathered over it:
    the backward reduce-scatters the gradient (sums the ranks' tokens),
    or with ``invariant`` keeps this rank's block (every rank along the
    axis computed the same gradient)."""
    group = mesh.axis_group(axis)
    if group is None:
        return w
    gather = all_gather_invariant if invariant else all_gather
    for dim in range(w.dim()):
        if axis in spec.entry(dim):
            w = gather(w, group, dim)
    return w


def _build_layer_body(c, mesh=None, seq_axis="seq", specs=None):
    """One decoder layer ``(x, lp) -> (x, aux)``, wrapped in the
    configured remat mode; under ``mesh`` on this rank's shard (rope at
    global positions, attention by :func:`_attention`) and this rank's
    blocks of the layer's params, whose ``specs`` (the lead dim's entry
    dropped) split them over ``fsdp`` (gathered here, one layer at a
    time, and so gathered again by the recompute of a remat mode rather
    than saved), ``tensor`` and ``expert``. Under ``full`` the backward
    re-runs the whole layer, K1 included; under the save-set modes it
    re-runs all but the saved ops, so K1 runs once per layer per grad
    call, under ``dots`` (which recomputes K1, as the TPU program does)
    twice. On a grouped MoE layer the backward needs ``y_slots`` (the
    router's combine gradient), so ``full``, ``dots``, ``attn``,
    ``attn+gate``, ``attn+gate+qkv`` and ``attn+ffn`` re-run all three
    grouped products (K5), ``attn+moe`` the gate and up products, ``moe``
    none."""
    tensor = _group(mesh, "tensor")
    grouped = _grouped(c, mesh)

    def layer(x, lp):
        bb, tt = x.shape[0], x.shape[1]
        # Global positions: this rank's sequence shard starts at
        # seq index x T_local.
        start = mesh.axis_index(seq_axis) * tt if mesh and seq_axis else 0
        positions = torch.arange(start, start + tt,
                                 device=x.device).expand(bb, tt)
        if mesh is not None:
            lp = {k: _gather_leaf(w, specs[k], mesh, "fsdp")
                  for k, w in lp.items()}
            if grouped:
                # The grouped dispatch runs every expert on each rank:
                # the experts gathered over ``expert``, where every rank
                # runs the same tokens (GSPMD's layout of JAX's program).
                lp = {k: _gather_leaf(w, specs[k], mesh, "expert",
                                      invariant=True)
                      for k, w in lp.items()}
        x = x + _attention_block(x, lp, c, positions, tensor, mesh,
                                 seq_axis)
        h = _rmsnorm(x, lp["mlp_norm"].to(c.compute_dtype), c.norm_eps)
        ff, aux = _ffn(h, lp, c, mesh, seq_axis)
        return x + ff, aux

    mode = c.remat
    if mode in ("attn+moe", "moe") and not grouped:
        # These modes save residuals only the grouped dispatch emits;
        # under the GShard dispatch or a dense config they would
        # silently degrade to plain "attn".
        raise ValueError(
            f"remat={mode!r} requires the grouped MoE dispatch "
            "(n_experts > 0 and moe_impl='grouped', or 'auto' with no "
            "mesh); use remat='attn' or 'attn+gate' here")
    if mode is False or mode == "none":
        return layer
    if mode is True or mode == "full":
        return functools.partial(checkpoint, layer, use_reentrant=False)
    if mode == "dots":
        return functools.partial(checkpoint, layer, use_reentrant=False,
                                 context_fn=_save_dots())
    if mode in _REMAT_SAVES:
        return functools.partial(
            checkpoint, layer, use_reentrant=False,
            context_fn=_save_only_these_names(_REMAT_SAVES[mode]))
    raise ValueError(f"unknown remat mode {mode!r}: expected True/'full', "
                     "'dots', 'attn', 'attn+gate', 'attn+gate+qkv', "
                     "'attn+ffn', 'attn+moe', 'moe', or False/'none'")


def _unbind_layers(layers):
    """Stacked [L, ...] layer params -> one dict of views per layer.
    ``unbind`` gives each stacked leaf ONE backward node that stacks the
    per-layer gradients once (indexing would add a full-size gradient
    per layer)."""
    keys = list(layers)
    return [dict(zip(keys, ws))
            for ws in zip(*(layers[k].unbind(0) for k in keys))]


_MM_OUT_DTYPE = hasattr(torch.ops.aten.mm, "dtype")


class _F32Logits(torch.autograd.Function):
    """h @ w with an f32 result and no bf16 rounding of the logits (the
    JAX ``preferred_element_type=float32``). On CUDA with bf16 operands
    the forward is ``torch.mm(..., out_dtype=float32)`` where this torch
    has it (bf16 tensor-core products, f32 accumulation and output);
    otherwise, and on the CPU, both operands are upcast to f32 — the
    same arithmetic, since bf16 products are exact in f32. The backward
    takes the f32 cotangent as JAX's transpose does: both products in
    f32, each gradient cast to its operand's dtype. f32 products follow
    ``torch.backends.cuda.matmul.allow_tf32`` (off by default)."""

    @staticmethod
    def forward(ctx, h, w):
        ctx.save_for_backward(h, w)
        h2 = h.reshape(-1, h.shape[-1])
        if h.is_cuda and h.dtype != torch.float32 and _MM_OUT_DTYPE:
            out = torch.mm(h2, w, out_dtype=torch.float32)
        else:
            out = torch.mm(h2.float(), w.float())
        return out.reshape(*h.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).float()
        dh = torch.mm(g2, w.float().t()).to(h.dtype).reshape(h.shape)
        dw = torch.mm(h.reshape(-1, h.shape[-1]).float().t(), g2)
        return dh, dw.to(w.dtype)


def llama_partition_rules(pipeline=False, virtual=1):
    """Megatron TP + FSDP sharding rules for the param tree (the JAX
    package's, for ``parallel.sharding.shard_params``). Layer-stacked
    leaves have a leading layer axis, unsharded, or with ``pipeline``
    split over the ``pipe`` axis into contiguous blocks (the stages).
    ``virtual > 1`` (the interleaved schedule's V) gives each stage its V
    chunks in device-major order instead (``sharding.Interleaved``), as
    JAX's engine permutes the stack inside every step; ``gather_params``
    returns the canonical order. ``tensor`` splits heads and the FFN
    width, ``fsdp`` the other matmul dim (ZeRO-3), ``expert`` the
    experts; the router stays replicated."""
    lead = None
    if pipeline:
        lead = Interleaved("pipe", virtual) if virtual > 1 else "pipe"
    return [
        (r"embed", P(("tensor", "fsdp"), None)),
        (r"layers/.*norm", P(lead, None)),
        (r"layers/w[qkv]$", P(lead, "fsdp", "tensor")),
        (r"layers/wo", P(lead, "tensor", "fsdp")),
        (r"layers/w_(gate|up)", P(lead, "fsdp", "tensor")),
        (r"layers/w_down", P(lead, "tensor", "fsdp")),
        (r"layers/router", P(lead, None, None)),
        (r"layers/moe_(gate|up)", P(lead, "expert", "fsdp", "tensor")),
        (r"layers/moe_down", P(lead, "expert", "tensor", "fsdp")),
        (r"final_norm", P(None)),
        (r"lm_head", P("fsdp", "tensor")),
    ]


def _param_shapes(c):
    """The global shape of every leaf of ``llama_init(c)``'s tree."""
    d, hd, L, F_ = c.d_model, c.head_dim, c.n_layers, c.d_ff
    layers = {"attn_norm": (L, d), "wq": (L, d, c.n_heads * hd),
              "wk": (L, d, c.n_kv_heads * hd),
              "wv": (L, d, c.n_kv_heads * hd),
              "wo": (L, c.n_heads * hd, d), "mlp_norm": (L, d)}
    if c.n_experts > 0:
        E = c.n_experts
        layers.update(router=(L, d, E), moe_gate=(L, E, d, F_),
                      moe_up=(L, E, d, F_), moe_down=(L, E, F_, d))
    else:
        layers.update(w_gate=(L, d, F_), w_up=(L, d, F_),
                      w_down=(L, F_, d))
    return {"embed": (c.vocab_size, d), "layers": layers,
            "final_norm": (d,), "lm_head": (d, c.vocab_size)}


def _n_stages(mesh):
    return 1 if mesh is None else mesh.shape["pipe"]


def _mesh_specs(params, c, mesh):
    """The spec tree of this rank's blocks under
    :func:`llama_partition_rules` (``pipeline`` when the mesh has a
    ``pipe`` axis), each block's shape checked."""
    t = mesh.shape["tensor"]
    if c.n_heads % t or c.n_kv_heads % t:
        raise ValueError(
            f"n_heads ({c.n_heads}) and n_kv_heads ({c.n_kv_heads}) must "
            f"divide over the 'tensor' axis ({t}): GSPMD would re-shard the "
            "heads here, which the port does not")
    return block_specs(params, _rules(c, mesh), _param_shapes(c), mesh)


def _rules(c, mesh):
    """:func:`llama_partition_rules` for ``c`` under ``mesh``."""
    pipelined = _n_stages(mesh) > 1
    return llama_partition_rules(pipelined, _virtual(c) if pipelined else 1)


def _sum_grads(params, specs, mesh, batch_axes=BATCH_AXES):
    """``params`` unchanged; in the backward each leaf's gradient is
    summed over the ``batch_axes`` its spec leaves replicated
    (``Mesh.grad_group``; an fsdp split's sum is its gather's
    reduce-scatter), one ``replicate`` a group."""
    leaves = tree_leaves(params)
    by_axes = {}
    for i, spec in enumerate(tree_leaves(specs)):
        by_axes.setdefault(tuple(a for a in spec.axes()
                                 if a in batch_axes), []).append(i)
    for axes, idx in by_axes.items():
        summed = replicate([leaves[i] for i in idx],
                           mesh.grad_group(axes, batch_axes))
        for i, x in zip(idx, summed):
            leaves[i] = x
    return tree_unflatten(params, leaves)


def _transport(mesh, transport):
    """The pipeline's transport: the mesh's ``pipe`` axis when it is
    larger than 1, the caller's in-process replay (no mesh), else None
    (no pipeline)."""
    if transport is not None:
        if mesh is not None:
            raise ValueError("transport= replays a pipeline in this "
                             "process: it takes no mesh")
        return transport
    if _n_stages(mesh) > 1:
        return pipeline.mesh_transport(mesh)
    return None


def _virtual(c):
    """Chunks a stage: the interleaved schedule's V, else 1."""
    return c.pipeline_virtual_stages \
        if c.pipeline_schedule == "interleaved_1f1b" else 1


def _validate_pipeline(c, b, mesh, seq_axis, n_stages):
    """The JAX package's pipeline preconditions (the same errors);
    returns the microbatch count M. ``b`` is this rank's batch, the
    global one ``b`` times the batch ranks; each microbatch's rows split
    evenly over those ranks."""
    M = c.pipeline_microbatches or n_stages
    if mesh is not None and seq_axis and mesh.shape.get(seq_axis, 1) > 1:
        raise ValueError("pipeline (pipe>1) and sequence parallelism "
                         "(seq>1) cannot combine: ring attention's "
                         "ring cannot run inside a pipeline stage")
    R = 1 if mesh is None else mesh.axes_size(ROW_AXES)
    if M <= 0 or (b * R) % M:
        raise ValueError(f"batch {b * R} must divide into "
                         f"{M} pipeline microbatches")
    if b % M:
        raise ValueError(f"the {b * R // M} rows of each of the {M} "
                         f"pipeline microbatches must split evenly over "
                         f"the {R} batch ranks")
    V = c.pipeline_virtual_stages
    if V < 1:
        raise ValueError(f"pipeline_virtual_stages must be >= 1, got {V}")
    if V > 1 and c.pipeline_schedule != "interleaved_1f1b":
        raise ValueError(
            f"pipeline_virtual_stages={V} requires "
            f"pipeline_schedule='interleaved_1f1b' "
            f"(got {c.pipeline_schedule!r})")
    chunks = n_stages * _virtual(c)
    if c.n_layers % chunks:
        raise ValueError(f"n_layers {c.n_layers} must divide into "
                         f"{chunks} pipeline stage chunks "
                         f"({n_stages} stages x {V} virtual)")
    return M


def _regroup(c, mesh, transport):
    """The batch group over which a pipelined MoE config moves its rows,
    else None. JAX cuts the global batch: microbatch m is the global rows
    [m B/M, (m+1) B/M), split over the batch ranks, while a rank holds
    the rows [r b, (r+1) b). The MoE aux loss is taken over a
    microbatch's tokens, so there rank r takes its share of each of
    JAX's microbatches (:func:`_to_microbatch_rows`); a dense config's
    numbers do not depend on which rows share a microbatch, and it keeps
    its rows."""
    if mesh is None or transport is None or c.n_experts == 0:
        return None
    return mesh.batch_group()


def _to_microbatch_rows(x, group, M):
    """``x`` [b, ...], this rank's rows of the global batch (the group's
    members in batch order), -> [b, ...] whose m-th b/M rows are this
    rank's share of JAX's microbatch m."""
    r = dist.get_rank(group)
    every = all_gather(x.contiguous(), group)          # the global rows
    return every.unflatten(0, (M, dist.get_world_size(group), -1))[
        :, r].flatten(0, 1)


def _from_microbatch_rows(y, group, M):
    """:func:`_to_microbatch_rows` undone (differentiable)."""
    b, r = y.shape[0], dist.get_rank(group)
    every = all_gather(y, group).unflatten(
        0, (dist.get_world_size(group), M, -1))        # member, m, row
    return every.transpose(0, 1).flatten(0, 2)[r * b:(r + 1) * b]


def _check_schedule(c):
    if c.pipeline_schedule not in pipeline.SCHEDULES:
        raise ValueError(
            f"unknown pipeline_schedule {c.pipeline_schedule!r}: "
            "expected 'gpipe', '1f1b', or 'interleaved_1f1b'")


def _stage_scan(body):
    """One pipeline chunk = ``body`` over its layers (the JAX
    ``_stage_scan``): ``(chunk params, x) -> (x, the sum of its layers'
    aux)``."""
    def stage_fn(chunk, x):
        aux = []
        for lp in _unbind_layers(chunk):
            x, a = body(x, lp)
            aux.append(a)
        return x, torch.stack(aux).sum()
    return stage_fn


def _layer_specs(specs):
    """The per-layer specs (the stacked leaves' lead entry dropped)."""
    return {k: P(*s[1:]) for k, s in specs["layers"].items()}


def llama_pipeline_programs(config, mesh=None, seq_axis="seq", *,
                            microbatches=1, denom=1.0):
    """``(stage_fn, loss_fn, aux_cotangent)``: the per-chunk program and
    the last stage's loss head the pipeline schedules run (the JAX
    ``llama_pipeline_programs``). ``stage_fn(chunk, x)`` runs the
    chunk's layers under the config's remat mode; ``loss_fn((final_norm,
    lm_head), y_mb, (targets, mask)) -> scalar`` is a microbatch's masked
    NLL sum over ``denom``, the global mask-token count (under ``mesh``
    on this rank's blocks: the lm_head gathered over ``fsdp``, the
    vocab-parallel NLL over ``tensor``, the sum over the batch axes);
    ``aux_cotangent`` is ``moe_aux_weight / (n_layers * microbatches)``
    for an MoE config, else 0."""
    c = config
    dt = c.compute_dtype
    specs, tensor = None, _group(mesh, "tensor")
    if mesh is not None:
        specs = param_specs(_param_shapes(c), _rules(c, mesh))
    stage_fn = _stage_scan(_build_layer_body(
        c, mesh, seq_axis, None if specs is None else _layer_specs(specs)))

    def loss_fn(hp, y, la):
        final_norm, lm_head = hp
        targets, mask = la
        h = _rmsnorm(y, final_norm.to(dt), c.norm_eps)
        if mesh is None:
            logits = _F32Logits.apply(h, lm_head.to(dt))
            return (_token_nll(logits, targets) * mask).sum() / denom
        lm_head = _gather_leaf(lm_head, specs["lm_head"], mesh, "fsdp")
        (h,) = replicate((h,), tensor)
        logits = _F32Logits.apply(h, lm_head.to(dt))
        nll = _vocab_parallel_nll(logits, targets, tensor,
                                  mesh.axis_index("tensor")
                                  * logits.shape[-1])
        return psum((nll * mask).sum(), mesh.batch_group()) / denom

    aux_ct = (c.moe_aux_weight / (c.n_layers * microbatches)
              if c.n_experts > 0 else 0.0)
    return stage_fn, loss_fn, aux_ct


def _prepare(params, tokens, c, device, mesh, rows=None):
    """The trunk's inputs: (params with each leaf's gradient sum over the
    batch axes, the spec tree or None, the embedded tokens [B, T, D],
    their rows moved by ``rows`` first when it is given)."""
    if mesh is not None:
        device = mesh.device if device is None else device
    _, a = on_device(params, device, tokens=tokens)
    tokens = a["tokens"] if rows is None else rows(a["tokens"])
    specs = None
    embed = params["embed"]
    if mesh is not None:
        specs = _mesh_specs(params, c, mesh)
        params = _sum_grads(params, specs, mesh)
        # The vocab lookup's "index passthrough": the table gathered over
        # both of its axes, then this rank's own tokens looked up.
        embed = _gather_leaf(_gather_leaf(params["embed"], specs["embed"],
                                          mesh, "fsdp"),
                             specs["embed"], mesh, "tensor", invariant=True)
    return params, specs, embed.to(c.compute_dtype)[tokens.long()]


def _trunk(params, x, c, mesh, seq_axis, specs, transport):
    """The decoder layers over ``x``: (their output, the MoE aux loss as
    the mean over layers and microbatches). Pipelined through gpipe when
    there is a ``transport``."""
    body = _build_layer_body(c, mesh, seq_axis,
                             None if specs is None else _layer_specs(specs))
    if transport is None:
        aux = []
        for lp in _unbind_layers(params["layers"]):
            x, aux_layer = body(x, lp)
            aux.append(aux_layer)
        return x, torch.stack(aux).mean()
    b, t, d = x.shape
    M = _validate_pipeline(c, b, mesh, seq_axis, transport.S)
    ys, aux_total = pipeline.gpipe(_stage_scan(body), params["layers"],
                                   x.reshape(M, b // M, t, d), transport,
                                   _virtual(c))
    return ys.reshape(b, t, d), aux_total / (c.n_layers * M)


def _local_logits(params, tokens, c, device, mesh, seq_axis, transport):
    """(this rank's f32 logits over its vocab block [B, T, V/tensor],
    the MoE aux loss): the trunk of :func:`llama_forward`."""
    group, rows = _regroup(c, mesh, transport), None
    if group is not None:
        M = _validate_pipeline(c, len(tokens), mesh, seq_axis, transport.S)
        rows = functools.partial(_to_microbatch_rows, group=group, M=M)
    params, specs, x = _prepare(params, tokens, c, device, mesh, rows)
    lm_head = params["lm_head"]
    if mesh is not None:
        lm_head = _gather_leaf(lm_head, specs["lm_head"], mesh, "fsdp")
    x, aux = _trunk(params, x, c, mesh, seq_axis, specs, transport)
    if group is not None:
        x = _from_microbatch_rows(x, group, M)
    dt = c.compute_dtype
    x = _rmsnorm(x, params["final_norm"].to(dt), c.norm_eps)
    (x,) = replicate((x,), _group(mesh, "tensor"))
    return _F32Logits.apply(x, lm_head.to(dt)), aux


def llama_forward(params, tokens, config, return_aux=False, device=None,
                  mesh=None, seq_axis="seq", transport=None):
    """tokens [B, T] int -> logits [B, T, vocab] (float32).

    With ``return_aux`` the MoE load-balancing loss (the mean over
    layers; 0 for dense configs) is returned alongside the logits.
    ``device`` follows the entry-point rule (``None`` means cuda, or the
    mesh's device); the params must lie there. Under ``mesh`` (a
    ``parallel.mesh.Mesh``) ``tokens`` is this rank's (batch, seq) shard
    (``mesh.shard``), ``params`` this rank's blocks
    (``parallel.sharding.shard_params(params, mesh,
    llama_partition_rules(pipeline))``, ``pipeline`` true when the mesh
    has a ``pipe`` axis; the whole tree when only ``data`` and ``seq``
    are larger than 1), and the logits are this rank's shard of the full
    vocab. Each leaf's gradient is summed over the batch axes its spec
    leaves replicated, less the axes a ZeRO step defers to its
    reduce-scatter (``Mesh.defer_grad_sum``); the ``tensor`` and
    ``expert`` axes follow Megatron's f/g placement, so every rank along
    them holds its block's whole gradient. A ``pipe`` axis runs the
    layers through gpipe (``parallel/pipeline.py``), this rank's stage
    (each rank's batch cut into ``pipeline_microbatches``, or one a
    stage); ``transport`` (a ``pipeline.InProcessTransport``, no mesh)
    replays the same pipeline with every stage in this process."""
    _check_schedule(config)
    logits, aux = _local_logits(params, tokens, config, device, mesh,
                                seq_axis, _transport(mesh, transport))
    if mesh is not None:
        logits = all_gather_invariant(logits, mesh.axis_group("tensor"), -1)
    if return_aux:
        return logits, aux
    return logits


def _token_nll(logits, targets):
    """Per-token negative log-likelihood in logsumexp form (no second
    [B, T, vocab] array for log_softmax)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - picked


def _vocab_parallel_nll(logits, targets, group, start):
    """:func:`_token_nll` of logits split over ``group`` along the vocab
    (this rank's block starts at ``start``): the max, the sum of
    exponentials and the target's logit are summed over the group, so no
    rank holds the [B, T, vocab] logits."""
    if group is None:
        return _token_nll(logits, targets)
    v = logits.shape[-1]
    with torch.no_grad():
        m = logits.amax(-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    lse = m + torch.log(psum(torch.exp(logits - m[..., None]).sum(-1),
                             group))
    local = targets.long() - start
    inside = (local >= 0) & (local < v)
    picked = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    return lse - psum(torch.where(inside, picked, torch.zeros_like(picked)),
                      group)


class _FusedSchedule(torch.autograd.Function):
    """JAX's ``custom_vjp`` around a fused schedule: the forward runs the
    schedule, which computes the loss and every gradient, and keeps the
    gradients; the backward scales them by the loss's cotangent."""

    @staticmethod
    def forward(ctx, run, *inputs):
        loss, grads = run(*inputs)
        ctx.save_for_backward(*grads)
        return loss

    @staticmethod
    def backward(ctx, dl):
        return (None, *[(g * dl).to(g.dtype) for g in ctx.saved_tensors])


def _fused_loss(params, batch, c, device, mesh, seq_axis, transport):
    """:func:`llama_loss` through ``1f1b`` or ``interleaved_1f1b`` (the
    JAX ``_llama_loss_1f1b``): the loss head on the last stage, the mask
    denominator global and taken outside the schedule, the MoE aux folded
    in by its constant cotangent (over JAX's global microbatches,
    :func:`_regroup`). A call that needs no gradient (grad
    mode off, or nothing requiring one) runs gpipe and the same loss head
    instead (JAX's ``schedule_primal``) and never enters the schedule."""
    M = _validate_pipeline(c, len(batch["tokens"]), mesh, seq_axis,
                           transport.S)
    group, rows = _regroup(c, mesh, transport), None
    if group is not None:
        rows = functools.partial(_to_microbatch_rows, group=group, M=M)
    params, specs, x = _prepare(params, batch["tokens"], c, device, mesh,
                                rows)
    b, t, d = x.shape
    targets = torch.as_tensor(batch["targets"], device=x.device)
    mask = batch.get("mask")
    mask = torch.ones((b, t), device=x.device) if mask is None \
        else torch.as_tensor(mask, device=x.device).float()
    if rows is not None:
        targets, mask = rows(targets), rows(mask)
    count = mask.sum() if mesh is None else psum(mask.sum(),
                                                 mesh.batch_group())
    denom = torch.clamp(count, min=1.0)
    stage_fn, loss_fn, aux_ct = llama_pipeline_programs(
        c, mesh, seq_axis, microbatches=M, denom=denom)
    xs = x.reshape(M, b // M, t, d)
    largs = (targets.reshape(M, b // M, t), mask.reshape(M, b // M, t))
    layers = params["layers"]
    head = [params["final_norm"], params["lm_head"]]
    V = _virtual(c)
    inputs = [*tree_leaves(layers), *head, xs]
    if not (torch.is_grad_enabled() and any(x.requires_grad
                                            for x in inputs)):
        ys, aux_total = pipeline.gpipe(stage_fn, layers, xs, transport, V)
        total = None
        for m in range(M):
            lm = loss_fn(head, ys[m], [a[m] for a in largs])
            total = lm if total is None else total + lm
        return total + aux_ct * aux_total

    n = len(inputs) - 3

    def run(*leaves):
        sp = tree_unflatten(layers, list(leaves[:n]))
        if c.pipeline_schedule == "interleaved_1f1b":
            out = pipeline.interleaved_one_f_one_b(
                stage_fn, loss_fn, sp, leaves[n:n + 2], leaves[-1], largs,
                transport, num_virtual=V, aux_cotangent=aux_ct)
        else:
            out = pipeline.one_f_one_b(
                stage_fn, loss_fn, sp, leaves[n:n + 2], leaves[-1], largs,
                transport, aux_cotangent=aux_ct)
        loss, aux, d_sp, d_hp, d_xs = out
        return loss + aux_ct * aux, [*tree_leaves(d_sp), *d_hp, d_xs]

    return _FusedSchedule.apply(run, *inputs)


def llama_loss(params, batch, config, device=None, mesh=None,
               seq_axis="seq", transport=None):
    """Causal LM loss (+ the weighted MoE aux loss for expert configs).
    batch = {"tokens": [B, T], "targets": [B, T], "mask": [B, T] or
    absent}: the mean token NLL, or the masked mean
    sum(nll * mask) / max(sum(mask), 1). Under ``mesh`` the batch is
    this rank's shard, the params its blocks (:func:`llama_forward`),
    and the loss is the global one, the same on every rank: the sum over
    the batch axes of each shard's sum(nll * mask) over the global token
    count, the NLL taken over the ``tensor`` axis's vocab blocks.

    With a ``pipe`` axis (or an in-process ``transport``) a ``gpipe``
    config runs the layers through gpipe and this loss on its output; a
    ``1f1b`` or ``interleaved_1f1b`` config runs the fused schedule
    (:func:`_fused_loss`), whose loss is sum(nll * mask) / max(sum(mask),
    1) with an all-ones mask when there is none."""
    _check_schedule(config)
    transport = _transport(mesh, transport)
    if transport is not None and config.pipeline_schedule != "gpipe":
        return _fused_loss(params, batch, config, device, mesh, seq_axis,
                           transport)
    logits, aux = _local_logits(params, batch["tokens"], config, device,
                                mesh, seq_axis, transport)
    targets = torch.as_tensor(batch["targets"], device=logits.device)
    mask = batch.get("mask")
    if mesh is None:
        nll = _token_nll(logits, targets)
        if mask is None:
            loss = nll.mean()
        else:
            mask = torch.as_tensor(mask, device=logits.device).float()
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    else:
        tensor = mesh.axis_group("tensor")
        nll = _vocab_parallel_nll(
            logits, targets, tensor,
            mesh.axis_index("tensor") * logits.shape[-1])
        group = mesh.batch_group()
        if mask is None:
            total = nll.sum()
            count = float(nll.numel() * mesh.axes_size(BATCH_AXES))
        else:
            mask = torch.as_tensor(mask, device=logits.device).float()
            total = (nll * mask).sum()
            count = torch.clamp(psum(mask.sum(), group), min=1.0)
        loss = psum(total, group) / count
    if config.n_experts > 0:
        loss = loss + config.moe_aux_weight * aux
    return loss
