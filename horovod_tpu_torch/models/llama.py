"""Llama-family decoder-only transformer: the port's dense and sparse
mixture-of-experts model.

Counterpart of horovod_tpu/models/llama.py. Parameters are a plain dict
with the JAX package's keys and stacked [L, ...] shapes (so a JAX tree
converts leaf for leaf, see ``convert.py``); the helpers are plain
functions on tensors, with the same numeric recipe as the JAX ones.

Ported here: ``LlamaConfig``, ``llama_init`` (dense and MoE trees),
``_rmsnorm``, ``_rope``, ``moe_route``, ``_ffn`` (dense SwiGLU, or the
dropless grouped MoE dispatch of ``ops/grouped_moe.py``), and the
training forward: ``llama_forward`` and ``llama_loss`` (the JAX
``lax.scan`` over layers is a Python loop over the unbound layer slices)
with the remat modes ``none``, ``full``, ``attn``, ``attn+gate``,
``attn+moe`` and ``moe``, on one device or, for dense configs, under a
``data`` x ``seq`` mesh (``parallel/mesh.py``): each rank runs its
shard of the batch, attention over the ``seq`` axis is ring or Ulysses
(``seq_parallel``), rope positions and the loss's mean are global, and
the replicated parameters' gradients are summed over the mesh (the
reduction JAX's GSPMD inserts). Tensor, fsdp and expert parallelism and
the GShard MoE dispatch (A8), pipelines (A10), and the other remat modes
(A1) are not ported yet and raise.

Remat is PyTorch's selective activation checkpointing, which decides per
dispatcher op. The JAX save-names map onto ops: ``flash_o``/``flash_lse``
are the outputs of the flash op ``hvd_torch::flash_fwd`` (K1), and
``ffn_gate`` is the pre-silu gate, produced by the named matmul op
``hvd_torch::named_matmul``; the MoE names are the outputs of the
grouped-MoE ops (``ops/grouped_moe.py``). On the sequence-parallel path
each ring step's chunk op ``hvd_torch::flash_chunk`` gives
``flash_o``/``flash_lse`` and the attention output is named ``attn_out``
by ``hvd_torch::checkpoint_name``, as JAX names it there.
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from horovod_tpu_torch._device import on_device, resolve_device
from horovod_tpu_torch.ops import grouped_moe
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel._tree import tree_leaves, tree_unflatten
from horovod_tpu_torch.parallel.ops import psum, replicate
from horovod_tpu_torch.parallel.ring_attention import ring_self_attention
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
    comments for each field). Fields the port does not use yet
    (capacity factor, pipeline and sequence parallelism, scan and flash
    tuning) are kept so that one config describes one model in both
    packages."""

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


@torch.library.custom_op("hvd_torch::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` under a save-name (JAX's ``checkpoint_name``): a copy made
    by one dispatcher op, so a remat policy can keep it."""
    return x.clone()


torch.library.register_autograd(
    "hvd_torch::checkpoint_name", lambda ctx, g: (g, None),
    setup_context=lambda ctx, inputs, output: None)


def moe_route(h, router_w, n_experts_per_token):
    """The one router, shared by the grouped dispatch and cached decode:
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
    E = router_w.shape[-1]
    logits = h.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)                    # [..., E]
    ranked = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = ranked.values[..., :n_experts_per_token]
    gate_idx = ranked.indices[..., :n_experts_per_token]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    lead = tuple(range(probs.dim() - 1))
    experts = torch.arange(E, device=h.device)
    top1 = (gate_idx[..., :1] == experts).float()
    aux = E * torch.sum(top1.mean(lead) * probs.mean(lead))
    return gate_vals, gate_idx.int(), aux


def _ffn(h, lp, c):
    """One layer's FFN on normalised activations: the dense SwiGLU, or
    top-K expert routing for MoE configs, dispatched as the JAX ``_ffn``
    with no mesh: ``moe_impl`` "auto" or "grouped" takes the dropless
    grouped path (K5/K6). Returns (y, aux_loss) (aux is 0 when dense).
    The dense pre-silu gate is named ``ffn_gate`` for
    remat="attn+gate"."""
    if c.n_experts > 0:
        if c.moe_impl in ("auto", "grouped"):
            return grouped_moe.grouped_moe_ffn(h, lp, c)
        if c.moe_impl == "gshard":
            raise NotImplementedError(
                "moe_impl='gshard' (the GShard dispatch of the "
                "expert-parallel mesh path) is not ported yet (ROADMAP.md "
                "A8); use 'auto' or 'grouped'")
        raise ValueError(f"unknown moe_impl {c.moe_impl!r}: expected "
                         "'auto', 'grouped', or 'gshard'")
    dt = c.compute_dtype
    gate = named_matmul(h, lp["w_gate"].to(dt), "ffn_gate")
    up = h @ lp["w_up"].to(dt)
    y = (F.silu(gate) * up) @ lp["w_down"].to(dt)
    return y, torch.zeros((), dtype=torch.float32, device=h.device)


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


_FLASH_OPS = (torch.ops.hvd_torch.flash_fwd.default,
              torch.ops.hvd_torch.flash_chunk.default)
_NAMED_OP = torch.ops.hvd_torch.named_matmul.default
_NAME_OP = torch.ops.hvd_torch.checkpoint_name.default
_GMM_OP = torch.ops.hvd_torch.gmm.default
_Y_SLOTS_OP = torch.ops.hvd_torch.gmm_unpermute.default
_X_SORTED_OP = torch.ops.hvd_torch.dispatch_gather.default

# The JAX save-sets of the ported modes (horovod_tpu/models/llama.py
# _build_layer_body), by name.
_MOE_EXTRA_SAVE = ("moe_x_sorted", "moe_gate_act", "moe_up_act")
_REMAT_SAVES = {
    "attn": ("attn_out", "flash_o", "flash_lse"),
    "attn+gate": ("attn_out", "flash_o", "flash_lse", "ffn_gate"),
    "attn+moe": ("attn_out", "flash_o", "flash_lse", "moe_y_slots"),
    "moe": ("attn_out", "flash_o", "flash_lse", "moe_y_slots",
            *_MOE_EXTRA_SAVE),
}
_REMAT_QUEUED = {"dots": "A1", "attn+ffn": "A1", "attn+gate+qkv": "A1"}


def _save_only_these_names(names):
    """A selective-checkpoint policy saving the ops that produce
    ``names`` and recomputing everything else in the backward."""
    def policy(ctx, op, *args, **kwargs):
        if op in _FLASH_OPS:
            saved = "flash_o" in names
        elif op is _NAMED_OP:
            saved = args[2] in names
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


def _build_layer_body(c, mesh=None, seq_axis="seq"):
    """One decoder layer ``(x, lp) -> (x, aux)``, wrapped in the
    configured remat mode; under ``mesh`` on this rank's shard (rope at
    global positions, attention by :func:`_attention`). Under ``full``
    the backward re-runs the whole layer, K1 included; under the
    save-set modes it re-runs all but the saved ops, so K1 runs once per
    layer per grad call. On an MoE layer the backward needs ``y_slots``
    (the router's combine gradient), so ``full``, ``attn`` and
    ``attn+gate`` re-run all three grouped products (K5), ``attn+moe``
    the gate and up products, ``moe`` none."""
    dt = c.compute_dtype

    def layer(x, lp):
        bb, tt = x.shape[0], x.shape[1]
        # Global positions: this rank's sequence shard starts at
        # seq index x T_local.
        start = mesh.axis_index(seq_axis) * tt if mesh and seq_axis else 0
        positions = torch.arange(start, start + tt,
                                 device=x.device).expand(bb, tt)
        h = _rmsnorm(x, lp["attn_norm"].to(dt), c.norm_eps)
        q = (h @ lp["wq"].to(dt)).reshape(bb, tt, c.n_heads, c.head_dim)
        kk = (h @ lp["wk"].to(dt)).reshape(bb, tt, c.n_kv_heads,
                                           c.head_dim)
        vv = (h @ lp["wv"].to(dt)).reshape(bb, tt, c.n_kv_heads,
                                           c.head_dim)
        q = _rope(q, positions, c.rope_theta)
        kk = _rope(kk, positions, c.rope_theta)
        attn = _attention(q, kk, vv, mesh, seq_axis, c.seq_parallel)
        x = x + attn.reshape(bb, tt, -1) @ lp["wo"].to(dt)
        h = _rmsnorm(x, lp["mlp_norm"].to(dt), c.norm_eps)
        ff, aux = _ffn(h, lp, c)
        return x + ff, aux

    mode = c.remat
    if mode in _REMAT_QUEUED:
        raise NotImplementedError(
            f"remat={mode!r} is not ported yet (ROADMAP.md "
            f"{_REMAT_QUEUED[mode]}); use 'none', 'full', 'attn', "
            "'attn+gate', 'attn+moe' or 'moe'")
    if mode in ("attn+moe", "moe") and not (
            c.n_experts > 0 and c.moe_impl in ("auto", "grouped")):
        # These modes save residuals only the grouped dispatch emits; on
        # a dense config they would silently degrade to plain "attn".
        raise ValueError(
            f"remat={mode!r} requires the grouped MoE dispatch "
            "(n_experts > 0 and moe_impl 'auto' or 'grouped'); use "
            "remat='attn' or 'attn+gate' here")
    if mode is False or mode == "none":
        return layer
    if mode is True or mode == "full":
        return functools.partial(checkpoint, layer, use_reentrant=False)
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


def llama_forward(params, tokens, config, return_aux=False, device=None,
                  mesh=None, seq_axis="seq"):
    """tokens [B, T] int -> logits [B, T, vocab] (float32).

    With ``return_aux`` the MoE load-balancing loss (the mean over
    layers; 0 for dense configs) is returned alongside the logits. ``device``
    follows the entry-point rule (``None`` means cuda, or the mesh's
    device); the params must lie there. Under ``mesh`` (a
    ``parallel.mesh.Mesh``) ``tokens`` is this rank's (data, seq) shard
    (``mesh.shard``) and the logits are its shard; the params are the
    same on every rank, and their gradients are summed over the mesh."""
    c = config
    if mesh is not None:
        if c.n_experts > 0:
            raise NotImplementedError(
                "an MoE config under a mesh (moe_impl 'auto' means the "
                "GShard dispatch there) is not ported yet (ROADMAP.md A8)")
        device = mesh.device if device is None else device
    _, a = on_device(params, device, tokens=tokens)
    if mesh is not None:
        params = tree_unflatten(params, replicate(tree_leaves(params),
                                                  mesh.group))
    dt = c.compute_dtype
    x = params["embed"].to(dt)[a["tokens"].long()]
    body = _build_layer_body(c, mesh, seq_axis)
    aux = []
    for lp in _unbind_layers(params["layers"]):
        x, aux_layer = body(x, lp)
        aux.append(aux_layer)
    x = _rmsnorm(x, params["final_norm"].to(dt), c.norm_eps)
    logits = _F32Logits.apply(x, params["lm_head"].to(dt))
    if return_aux:
        return logits, torch.stack(aux).mean()
    return logits


def _token_nll(logits, targets):
    """Per-token negative log-likelihood in logsumexp form (no second
    [B, T, vocab] array for log_softmax)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - picked


def llama_loss(params, batch, config, device=None, mesh=None,
               seq_axis="seq"):
    """Causal LM loss (+ the weighted MoE aux loss for expert configs).
    batch = {"tokens": [B, T], "targets": [B, T], "mask": [B, T] or
    absent}: the mean token NLL, or the masked mean
    sum(nll * mask) / max(sum(mask), 1). Under ``mesh`` the batch is
    this rank's shard and the loss is the global one, the same on every
    rank: the sum over the mesh of each shard's sum(nll * mask) over the
    global token count."""
    logits, aux = llama_forward(params, batch["tokens"], config,
                                return_aux=True, device=device, mesh=mesh,
                                seq_axis=seq_axis)
    nll = _token_nll(logits, torch.as_tensor(batch["targets"],
                                             device=logits.device))
    mask = batch.get("mask")
    if mesh is not None:
        if mask is None:
            total, count = nll.sum(), float(nll.numel() * mesh.size)
        else:
            mask = torch.as_tensor(mask, device=logits.device).float()
            total = (nll * mask).sum()
            count = torch.clamp(psum(mask.sum(), mesh.group), min=1.0)
        loss = psum(total, mesh.group) / count
    elif mask is None:
        loss = nll.mean()
    else:
        mask = torch.as_tensor(mask, device=logits.device).float()
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    if config.n_experts > 0:
        loss = loss + config.moe_aux_weight * aux
    return loss
