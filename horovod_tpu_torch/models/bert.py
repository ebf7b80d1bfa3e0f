"""BERT-family encoder: the port's bidirectional model.

Counterpart of horovod_tpu/models/bert.py. Parameters are a plain dict
with the JAX package's keys and stacked [L, ...] shapes (so a JAX tree
converts leaf for leaf, see ``convert.py``), f32, cast to the compute
dtype at use; the helpers follow the JAX ones' numeric recipe:

- ``_layernorm`` in f32 with the population variance and
  ``rsqrt(var + eps)``, the f32 scale and bias applied before the cast
  back;
- ``jax.nn.gelu``'s default, the tanh approximation;
- attention through the flash op with the padding mask as its per-key
  bias ``where(mask > 0, 0, -1e30)`` in f32 (K1's bias variant forward,
  K2/K3's backward), non-causal;
- ``jax.checkpoint`` of each layer under ``remat`` as
  ``torch.utils.checkpoint`` (the backward re-runs the layer, K1
  included: K1 twice per layer per grad call, K2 and K3 once);
- the MLM head: gelu, layernorm, then f32 logits against the tied
  ``embed`` plus ``mlm_bias`` (a plain f32 product, outside any kernel).

A sequence that is all padding attends to no key: its attention output
is 0, as the Pallas kernel gives (JAX's CPU fallback gives the mean of
V instead); the loss masks such a sequence either way.

The JAX ``lax.scan`` over layers is a Python loop over the unbound
layer slices. Under a mesh (``parallel/mesh.py``) each rank runs its
shard of the batch's rows (``data`` and ``fsdp``, JAX's ``P(("data",
"fsdp"))``; ranks along ``seq`` and ``expert``, which the rules leave
unnamed, repeat the same work, as under GSPMD) on its blocks of the
params under :func:`bert_partition_rules` (JAX's Megatron + FSDP rules),
and inserts the collectives JAX's GSPMD inserts:

- attention over the rank's H/tensor heads: wq/wk/wv column blocks, wo a
  row block, ``replicate`` in and ``psum`` out (Megatron), K1–K3's bias
  variant on the rank's heads with the padding bias unchanged;
- the MLP: ``w_in``/``b_in`` column blocks, ``w_out`` a row block, the
  replicated ``b_out`` added once after the ``psum``;
- the tied embedding (``P("tensor", "fsdp")``): a vocab-parallel lookup
  (each rank's vocab block, the rows summed over ``tensor``),
  vocab-parallel logits with ``mlm_bias``'s block, and the loss through
  the vocab-parallel NLL (``models/llama.py``);
- the MLM head's ``mlm_dense`` (``P("fsdp", "tensor")``): its output
  columns gathered over ``tensor`` before the MLM layernorm;
- every ``fsdp`` leaf gathered over ``fsdp`` where it is used, a layer
  at a time (again by a remat's recompute), its gradient
  reduce-scattered; each leaf's gradient summed over the batch axes its
  spec leaves replicated.
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch._device import on_device, resolve_device
from horovod_tpu_torch.models.llama import (
    _gather_leaf,
    _sum_grads,
    _token_nll,
    _unbind_layers,
    _vocab_parallel_nll,
    torch_dtype,
)
from horovod_tpu_torch.ops.flash_attention import flash_attention
from horovod_tpu_torch.parallel.mesh import ROW_AXES
from horovod_tpu_torch.parallel.ops import all_gather_invariant, psum, replicate
from horovod_tpu_torch.parallel.sharding import P, block_specs

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """Field-for-field mirror of the JAX ``BertConfig``."""

    vocab_size: int = 30522
    max_position: int = 512
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    norm_eps: float = 1e-12
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def head_dim(self):
        return self.d_model // self.n_heads

    @property
    def compute_dtype(self):
        return torch_dtype(self.dtype)

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def large():
        return BertConfig(d_model=1024, n_layers=24, n_heads=16, d_ff=4096)

    @staticmethod
    def tiny(**kw):
        defaults = dict(vocab_size=256, max_position=128, d_model=64,
                        n_layers=2, n_heads=4, d_ff=128)
        defaults.update(kw)
        return BertConfig(**defaults)


def bert_init(config, generator, device=None):
    """Random f32 parameters with the JAX ``bert_init``'s keys and shapes
    (the values differ: torch and JAX draw different streams from one
    seed). Normals are drawn on ``generator``'s device, scaled (0.02 for
    the embeddings, fan_in^-1/2 for the dense weights) and moved to
    ``device``."""
    c = config
    dev = resolve_device(device)
    L, d = c.n_layers, c.d_model

    def normal(shape, std):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return x.mul_(std).to(dev)

    def dense(shape, fan_in):
        return normal(shape, fan_in ** -0.5)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        "embed": normal((c.vocab_size, d), 0.02),
        "pos_embed": normal((c.max_position, d), 0.02),
        "embed_norm": {"scale": ones(d), "bias": zeros(d)},
        "layers": {
            "attn_norm_scale": ones(L, d),
            "attn_norm_bias": zeros(L, d),
            "wq": dense((L, d, d), d),
            "wk": dense((L, d, d), d),
            "wv": dense((L, d, d), d),
            "wo": dense((L, d, d), d),
            "mlp_norm_scale": ones(L, d),
            "mlp_norm_bias": zeros(L, d),
            "w_in": dense((L, d, c.d_ff), d),
            "b_in": zeros(L, c.d_ff),
            "w_out": dense((L, c.d_ff, d), c.d_ff),
            "b_out": zeros(L, d),
        },
        "mlm_norm": {"scale": ones(d), "bias": zeros(d)},
        "mlm_dense": dense((d, d), d),
        "mlm_bias": zeros(c.vocab_size),   # head weights tied to embed
    }


def bert_partition_rules():
    """Megatron TP + FSDP rules (the JAX package's, for
    ``parallel.sharding.shard_params``): heads and the MLP width over
    ``tensor``, the other matmul dim over ``fsdp``, the tied embedding's
    vocab over ``tensor``; the norms and ``b_out`` replicated."""
    return [
        (r"pos_embed", P(None, "fsdp")),
        (r"^embed$", P("tensor", "fsdp")),
        (r".*norm.*", P()),
        (r"layers/w[qkv]$", P(None, "fsdp", "tensor")),
        (r"layers/wo", P(None, "tensor", "fsdp")),
        (r"layers/w_in", P(None, "fsdp", "tensor")),
        (r"layers/b_in", P(None, "tensor")),
        (r"layers/w_out", P(None, "tensor", "fsdp")),
        (r"layers/b_out", P(None, None)),
        (r"mlm_dense", P("fsdp", "tensor")),
        (r"mlm_bias", P("tensor")),
    ]


def _param_shapes(c):
    """The global shape of every leaf of ``bert_init(c)``'s tree."""
    L, d = c.n_layers, c.d_model
    norm = {"scale": (d,), "bias": (d,)}
    layers = {k: (L, d) for k in ("attn_norm_scale", "attn_norm_bias",
                                  "mlp_norm_scale", "mlp_norm_bias",
                                  "b_out")}
    layers.update(wq=(L, d, d), wk=(L, d, d), wv=(L, d, d), wo=(L, d, d),
                  w_in=(L, d, c.d_ff), b_in=(L, c.d_ff),
                  w_out=(L, c.d_ff, d))
    return {"embed": (c.vocab_size, d), "pos_embed": (c.max_position, d),
            "embed_norm": norm, "layers": layers, "mlm_norm": dict(norm),
            "mlm_dense": (d, d), "mlm_bias": (c.vocab_size,)}


def _mesh_specs(params, c, mesh):
    """The spec tree of this rank's blocks under
    :func:`bert_partition_rules`, each block's shape checked."""
    t = mesh.shape["tensor"]
    if c.n_heads % t:
        raise ValueError(f"n_heads ({c.n_heads}) must divide over the "
                         f"'tensor' axis ({t})")
    return block_specs(params, bert_partition_rules(), _param_shapes(c),
                       mesh)


def _layernorm(x, scale, bias, eps):
    """f32 mean and population variance, rsqrt(var + eps), the f32 scale
    and bias, then the cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _attention_block(h, lp, kv_bias, c, tensor=None):
    """The attention sublayer's output on this rank's blocks (the
    residual not added): layernorm, q/k/v by the column blocks of
    wq/wk/wv (this rank's heads), the flash op with the per-key bias,
    the row block of wo, the partial output summed over ``tensor``
    (Megatron; None: this rank's partial sum)."""
    dt = c.compute_dtype
    bb, tt = h.shape[0], h.shape[1]
    hn = _layernorm(h, lp["attn_norm_scale"], lp["attn_norm_bias"],
                    c.norm_eps)
    (hn,) = replicate((hn,), tensor)
    q = (hn @ lp["wq"].to(dt)).reshape(bb, tt, -1, c.head_dim)
    k = (hn @ lp["wk"].to(dt)).reshape(bb, tt, -1, c.head_dim)
    v = (hn @ lp["wv"].to(dt)).reshape(bb, tt, -1, c.head_dim)
    attn = flash_attention(q, k, v, causal=False, kv_bias=kv_bias)
    return psum(attn.reshape(bb, tt, -1) @ lp["wo"].to(dt), tensor)


def _mlp_block(h, lp, c, tensor=None):
    """The MLP sublayer's output before ``b_out`` on this rank's blocks:
    layernorm, the column blocks of w_in and b_in, gelu, the row block of
    w_out, the partial output summed over ``tensor``."""
    dt = c.compute_dtype
    hn = _layernorm(h, lp["mlp_norm_scale"], lp["mlp_norm_bias"], c.norm_eps)
    (hn,) = replicate((hn,), tensor)
    ff = _gelu(hn @ lp["w_in"].to(dt) + lp["b_in"].to(dt))
    return psum(ff @ lp["w_out"].to(dt), tensor)


def _layer(h, lp, kv_bias, c, mesh=None, specs=None):
    """One encoder layer (pre-norm, as the JAX ``layer``); under ``mesh``
    on this rank's blocks (``specs`` without the layer dim), its fsdp
    leaves gathered here, the replicated ``b_out`` added once after the
    MLP's sum."""
    tensor = None
    if mesh is not None:
        tensor = mesh.axis_group("tensor")
        lp = {k: _gather_leaf(w, specs[k], mesh, "fsdp")
              for k, w in lp.items()}
    h = h + _attention_block(h, lp, kv_bias, c, tensor)
    return h + (_mlp_block(h, lp, c, tensor) + lp["b_out"].to(c.compute_dtype))


def _local_logits(params, tokens, c, attention_mask, device, mesh):
    """This rank's f32 MLM logits over its vocab block [B, T, V/tensor]
    (the whole vocab without a mesh): the trunk of :func:`bert_forward`."""
    if mesh is not None:
        device = mesh.device if device is None else device
    _, a = on_device(params, device, tokens=tokens,
                     attention_mask=attention_mask)
    dt = c.compute_dtype
    tokens = a["tokens"].long()
    bb, tt = tokens.shape
    mask = a["attention_mask"]
    if mask is None:
        kv_bias = torch.zeros((bb, tt), dtype=torch.float32,
                              device=tokens.device)
    else:
        # Finite (not -inf): a sequence that is all padding stays finite.
        kv_bias = torch.where(mask > 0, 0.0, _NEG).to(torch.float32)

    specs, tensor = None, None
    embed, pos_embed = params["embed"], params["pos_embed"]
    mlm_dense = params["mlm_dense"]
    if mesh is None:
        h = embed[tokens]
    else:
        specs = _mesh_specs(params, c, mesh)
        params = _sum_grads(params, specs, mesh, ROW_AXES)
        tensor = mesh.axis_group("tensor")
        embed, pos_embed, mlm_dense = (
            _gather_leaf(params[k], specs[k], mesh, "fsdp")
            for k in ("embed", "pos_embed", "mlm_dense"))
        # The vocab-parallel lookup: this rank's vocab block's rows (the
        # other tokens' rows 0), summed over ``tensor``.
        v = embed.shape[0]
        local = tokens - mesh.axis_index("tensor") * v
        inside = (local >= 0) & (local < v)
        rows = embed[local.clamp(0, v - 1)]
        h = psum(torch.where(inside[..., None], rows,
                             torch.zeros_like(rows)), tensor)
        specs = {k: P(*sp[1:]) for k, sp in specs["layers"].items()}
    h = h + pos_embed[None, :tt]
    h = _layernorm(h.to(dt), params["embed_norm"]["scale"],
                   params["embed_norm"]["bias"], c.norm_eps)
    body = functools.partial(_layer, kv_bias=kv_bias, c=c, mesh=mesh,
                             specs=specs)
    if c.remat:
        body = functools.partial(checkpoint, body, use_reentrant=False)
    for lp in _unbind_layers(params["layers"]):
        h = body(h, lp)

    # MLM head: dense + norm, decode against the tied embedding.
    (h,) = replicate((h,), tensor)
    h = _gelu(h @ mlm_dense.to(dt))
    if tensor is not None:
        # Every rank along ``tensor`` goes on alike from here.
        h = all_gather_invariant(h, tensor, -1)
    h = _layernorm(h, params["mlm_norm"]["scale"], params["mlm_norm"]["bias"],
                   c.norm_eps)
    (h,) = replicate((h,), tensor)
    return h.float() @ embed.t() + params["mlm_bias"]


def bert_forward(params, tokens, config, attention_mask=None, device=None,
                 mesh=None):
    """tokens [B, T] int -> MLM logits [B, T, vocab] (f32).

    ``attention_mask`` [B, T] with 1 = real token, 0 = padding (absent:
    every token is real). ``device`` follows the entry-point rule
    (``None`` means cuda, or the mesh's device); the params must lie
    there. Under ``mesh`` (a ``parallel.mesh.Mesh``) ``tokens`` and the
    mask are this rank's rows (``mesh.shard(x, seq_dim=None)``),
    ``params`` its blocks (``parallel.sharding.shard_params(params, mesh,
    bert_partition_rules())``), and the logits are its rows' over the
    whole vocab."""
    logits = _local_logits(params, tokens, config, attention_mask, device,
                           mesh)
    if mesh is not None:
        logits = all_gather_invariant(logits, mesh.axis_group("tensor"), -1)
    return logits


def bert_mlm_loss(params, batch, config, device=None, mesh=None):
    """Masked-LM loss. batch = {"tokens": [B, T] (with [MASK] ids),
    "targets": [B, T] original ids, "mlm_mask": [B, T] 1 where predicted,
    optional "attention_mask": [B, T]}: sum(nll * m) / max(sum(m), 1).
    Under ``mesh`` the batch is this rank's rows and the params its
    blocks (:func:`bert_forward`); the loss is the global one, the same
    on every rank, the NLL taken over the ``tensor`` axis's vocab
    blocks."""
    logits = _local_logits(params, batch["tokens"], config,
                           batch.get("attention_mask"), device, mesh)
    dev = logits.device
    targets = torch.as_tensor(batch["targets"], device=dev)
    m = torch.as_tensor(batch["mlm_mask"], device=dev).float()
    if mesh is None:
        nll = _token_nll(logits, targets)
        return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
    nll = _vocab_parallel_nll(logits, targets, mesh.axis_group("tensor"),
                              mesh.axis_index("tensor") * logits.shape[-1])
    group = mesh.batch_group(ROW_AXES)
    return psum((nll * m).sum(), group) / torch.clamp(psum(m.sum(), group),
                                                      min=1.0)
