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

Single device: the JAX ``lax.scan`` over layers is a Python loop over
the unbound layer slices. The mesh path and its partition rules wait
for A8 (ROADMAP.md).
"""

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from horovod_tpu_torch._device import on_device, resolve_device
from horovod_tpu_torch.models.llama import (
    _token_nll,
    _unbind_layers,
    torch_dtype,
)
from horovod_tpu_torch.ops.flash_attention import flash_attention

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
    """The JAX package's megatron TP + FSDP rules: not ported yet."""
    raise NotImplementedError(
        "bert_partition_rules (the mesh path's TP + FSDP sharding) is not "
        "ported yet (ROADMAP.md A8)")


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


def _layer(h, lp, kv_bias, c):
    """One encoder layer (pre-norm, as the JAX ``layer``)."""
    dt = c.compute_dtype
    bb, tt = h.shape[0], h.shape[1]
    hn = _layernorm(h, lp["attn_norm_scale"], lp["attn_norm_bias"],
                    c.norm_eps)
    q = (hn @ lp["wq"].to(dt)).reshape(bb, tt, c.n_heads, c.head_dim)
    k = (hn @ lp["wk"].to(dt)).reshape(bb, tt, c.n_heads, c.head_dim)
    v = (hn @ lp["wv"].to(dt)).reshape(bb, tt, c.n_heads, c.head_dim)
    attn = flash_attention(q, k, v, causal=False, kv_bias=kv_bias)
    h = h + attn.reshape(bb, tt, c.d_model) @ lp["wo"].to(dt)
    hn = _layernorm(h, lp["mlp_norm_scale"], lp["mlp_norm_bias"], c.norm_eps)
    ff = _gelu(hn @ lp["w_in"].to(dt) + lp["b_in"].to(dt))
    return h + (ff @ lp["w_out"].to(dt) + lp["b_out"].to(dt))


def bert_forward(params, tokens, config, attention_mask=None, device=None):
    """tokens [B, T] int -> MLM logits [B, T, vocab] (f32).

    ``attention_mask`` [B, T] with 1 = real token, 0 = padding (absent:
    every token is real). ``device`` follows the entry-point rule
    (``None`` means cuda); the params must lie there."""
    c = config
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

    h = params["embed"][tokens] + params["pos_embed"][None, :tt]
    h = _layernorm(h.to(dt), params["embed_norm"]["scale"],
                   params["embed_norm"]["bias"], c.norm_eps)
    body = functools.partial(_layer, kv_bias=kv_bias, c=c)
    if c.remat:
        body = functools.partial(checkpoint, body, use_reentrant=False)
    for lp in _unbind_layers(params["layers"]):
        h = body(h, lp)

    # MLM head: dense + norm, decode against the tied embedding.
    h = _gelu(h @ params["mlm_dense"].to(dt))
    h = _layernorm(h, params["mlm_norm"]["scale"], params["mlm_norm"]["bias"],
                   c.norm_eps)
    return h.float() @ params["embed"].t() + params["mlm_bias"]


def bert_mlm_loss(params, batch, config, device=None):
    """Masked-LM loss. batch = {"tokens": [B, T] (with [MASK] ids),
    "targets": [B, T] original ids, "mlm_mask": [B, T] 1 where predicted,
    optional "attention_mask": [B, T]}: sum(nll * m) / max(sum(m), 1)."""
    logits = bert_forward(params, batch["tokens"], config,
                          attention_mask=batch.get("attention_mask"),
                          device=device)
    dev = logits.device
    nll = _token_nll(logits, torch.as_tensor(batch["targets"], device=dev))
    m = torch.as_tensor(batch["mlm_mask"], device=dev).float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
